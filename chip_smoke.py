#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one GPU, and check its
hand-written kernels against their plain PyTorch versions.

Run from the repository root on a machine with an NVIDIA GPU (built for
the H100, ``sm_90a``):

    python3 chip_smoke.py

Phases, one line each (every check raises on failure):

1. the device (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of ``mini_mcmc_torch/csrc`` with ``nvcc`` (seconds), and the
   registers, stack frame and spills of every instance of Kernels 1-8
   (``ptxas -v``, ``[ptxas_instance]``; the whitened instances of Kernels
   1-4 and the scaled ones of Kernel 7 included); with ``--profile``, each
   Kernel 5 and 6
   instance's K loop in its SASS (``cuobjdump -sass``): instructions per
   step, by kind, and each Kernel 7 instance's leapfrog loop, which must
   hold no division (``[sass_k7]``: no MUFU.RCP, FCHK or CALL);
3. Philox: the known-answer vector, and CUDA bits equal to the plain bits
   on 2**20 counters;
4. the main path at the flagship size of ``bench.py`` (Rosenbrock3D HMC,
   65,536 chains x 8,192 draws, L = 192, K = 16, jitter 0.3) through
   ``mini_mcmc_torch.HMC(use_pallas="full")``: burn-in run, timed run,
   the five ``bench.py`` quality gates, the kernel launch counts, and a
   short ``use_pallas=True`` run through the same entry point;
5. the leapfrog kernel against its plain version (L = 8 and L = 192) on the
   main path's equilibrium state;
6. the multistep kernel against its plain version (K = 16, L = 8) from
   the same state and seed;
7. kernel and plain times at the main path's shapes (CUDA events); then
   the whitened instances of Kernels 1 and 2 (``metric=``): a diagonal
   metric estimated from the equilibrium, ``HMC(metric=)`` on 4,096 of
   its chains through both tiers (one block each, counted), each kernel
   against its twin from that whitened state as in 5 and 6, and both
   kernels' times on all 65,536 chains whitened;
8. with ``--profile`` only: five more timed runs (their spread), one run
   under ``torch.profiler`` (device time by kernel, the device's idle
   share) and Kernel 1's device time per call;
8a. the tuned-MALA stage of ``bench.py:732-779`` (``diffable_gaussian2d(
   [0,1], [[4,2],[2,3]])``, 65,536 chains, ``MALA(step_size=1.0,
   use_pallas="full", steps_per_call=16).seed(13).tuned(256)``, then
   ``run(2048, 0)`` twice): the gates of ``bench.py:757-766``, Kernel 1's
   256 launches while tuning and Kernel 2's 128 per run at L = 1; then
   Kernel 2 at L = 1 against its plain version for one block, and both
   times, and Kernel 1 at L = 1 (the tuning path's trajectory) and its
   plain version's (``--profile``: the run under ``torch.profiler`` and
   Kernel 1's device time at L = 1);
9. the NUTS stage of ``bench.py`` (Gaussian2D, 131,072 chains, 2,048 + 128
   draws) through ``mini_mcmc_torch.NUTS(use_pallas="full")``: adaptation
   run, timed run, the five ``bench_nuts`` gates, Kernel 4's launch count
   (one per step, 2 x 2,175), and a short ``use_pallas=True`` run
   counted on its own (Kernel 3); then its dense-metric half
   (``bench.py:355-387``): ``reconditioned("dense", seed=11)``, adaptation
   run, timed run, the gates of ``bench.py:370-379``, Kernel 4's whitened
   instance once a step (2 x 2,175, no plain twin), and a short
   ``use_pallas=True`` run with the metric (Kernel 3's whitened instance);
10. Kernel 3 against its plain version at j = 0..5 and 10 on the NUTS
    equilibrium state, and at j = 5 and 10 with the step cut by 2^-j so
    that most chains integrate all 2^j leaves (the whole stack and merge
    cascade): counts and flags on active and inactive chains apart, its
    lane-iterations per leaf and blocks per SM at each j; with
    ``--profile``, its device time per launch at j = 0..5 (``[k3_alone]``,
    ``torch.profiler`` over 20 launches, twice);
11. Kernel 4 against its plain version for one step, same key and step
    (positions, alpha, n_alpha, divergences and each chain's own depth),
    its load balance (lane-iterations per leaf), its persistent grid, and
    its result bit for bit under other grids;
12. NUTS kernel and plain times at those shapes (CUDA events); then Kernel
    4's and Kernel 3's (j = 4) whitened instances against their twins at
    the dense stage's equilibrium, and their times;
13. with ``--profile`` only: Kernel 3 alone at j = 0..5, one NUTS run
    under ``torch.profiler``, Kernel 4 alone (device time per call) and
    under three smaller grids, and one ``use_pallas=True`` run under
    ``torch.profiler`` (Kernel 3's launches, device time per launch, the
    idle share), and one dense-metric run under ``torch.profiler``;
14. the MH stage of ``bench.py:391-431`` (Gaussian2D, 65,536 chains,
    2,048 draws, isotropic walk, K = 16) through
    ``mini_mcmc_torch.MetropolisHastings(use_pallas="full")``: warm-up run,
    timed run, the four ``bench_mh_gauss2d`` gates, Kernel 5's launch
    count (128 per run);
15. the Poisson MH stage of ``bench.py:495-525`` (int32 states, 65,536
    chains, ``run(200, 100)``, K = 10): the pmf gate and Kernel 5's launch
    count (30 per run);
16. the Gibbs stage of ``bench.py:434-478`` (two-component mixture, 65,536
    chains, 8,192 sweeps, K = 32) through
    ``mini_mcmc_torch.GibbsSampler(use_pallas="full")``: the four
    ``bench_gibbs`` gates and Kernel 6's launch count (256 per run);
17. Kernels 5 (both instances) and 6 against their plain versions for one
    block from each path's equilibrium state and one key, and their times
    (CUDA events); with ``--profile``, the three alone (device time per
    launch) and each path under ``torch.profiler``;
17a. the MH stage's configuration started at a 25-sigma walk and
    ``tuned(256)``, ``run(2048, 0)`` twice through Kernel 5 at the tuned
    scale: the MH gates and a move rate in [0.15, 0.32]; then Kernel 5
    against its plain version at that scale, and both times;
18. the large-D HMC stage of ``bench.py:553-660`` (standard normal,
    D = 10,000, 1,024 chains, eps 0.1, L = 10, ``run(128, 128)`` twice,
    a 5.24 GB cube) through ``mini_mcmc_torch.HMC(use_pallas="separable")``
    and through the plain tier: the four ``bench.py:635-640`` gates on each,
    time per run, draws/s, coordinate updates/s, the speedup over the plain
    tier, Kernel 7's launch count (256 fused steps per run, no two-pass
    launch);
19. its L-scaling sub-stage (``bench.py:668-700``: seed 3, eps 0.05,
    L = 40, ``run(32, 32)``) through both tiers: the moment gates, the
    speedup, Kernel 7's launch count (64 per run);
20. Kernel 7 against its plain versions for one step from the stage's
    equilibrium state: the trajectory-only form (the proposal per chain
    against a float64 twin, the three sums at rtol 1e-5, the draws under
    two launch grids) and the fused step (accept decisions per chain
    against the float32 and float64 twins, positions per chain against
    float64, logp and alpha_c, the same step in clusters of 10 and in the
    two-pass form), and the times of both
    forms and the twin (CUDA events, L = 10 and 40);
20a. the separable stage's shape on the heterogeneous normal (sigma_d =
    logspace(-1, 1, D)): ``HMC(use_pallas="separable").seed(2)
    .warmed_up(128, "diag")``, ``run(128, 128)`` twice through Kernel 7's
    scaled instance (a diagonal metric), the separable gates on z = x /
    sigma, its launches (128 unscaled while tuning, 640 scaled), and 32
    steps at the tuned eps averaging an acceptance within 0.10 of 0.651;
    then the scaled instance against its plain versions as in 20, its
    time and its twin's; with ``--profile``, the device time alone
    (``[k7_alone]``, ``torch.profiler``) of the fused step in clusters of
    5 and of 10 and of the trajectory-only form, for the standard normal,
    the sigma table and the scaled sigma table, and each separable run under ``torch.profiler``
    with no ``[C, D]`` kernel launched a step beside Kernel 7;
21. the tempering stage of ``bench.py:858-909`` (the 0.3/0.7 mixture of
    N(-8, 0.5^2) and N(8, 0.5^2), 8,192 chains started at -8, 8 rungs,
    K = 16, ``run(2048, 0)`` twice) through
    ``mini_mcmc_torch.ParallelTempering(use_pallas="full")`` and through
    the plain tier: the four ``bench.py:890-898`` gates on each, time per
    run, cold draws/s, replica updates/s, Kernel 8's launch count (128 per
    run);
22. Kernel 8 against its plain version for one K = 16 block from the
    stage's equilibrium state (positions, logp, swap EWMA and history
    equal per chain), and both times (CUDA events); with ``--profile``,
    both stages under ``torch.profiler``.

23. ``run_progress`` on the flagship (``[run_progress]``): ``HMC.run_progress(
    8192, 8192, time_major=True)`` against a twin sampler's ``run(8192,
    8192, time_major=True)`` from the same seed (run, progress, progress,
    run): the cubes equal bit for bit, Kernel 2's 1,024 launches in each,
    the bench gates on the progress cube, its RunStats, the rendered lines
    and both wall times;
24. ``stream_run`` of the flagship (``[stream_run]``): 8,192 draws after
    8,192 in chunks of 1,024, each chunk equal to the twin cube's rows;
    the tracker's acceptance and live R-hat beside the split R-hat;
25. ``summary`` and ``rank_normalized_diagnostics`` on the card
    (``[summary_on_card]``, CUDA events and peak memory) on the gate's
    [512, 2048, 3] sub-cube, held to the CPU's summary, and on the last 512
    draws of all 65,536 chains (33,554,432 draws a parameter);
26. ``run_progress`` against ``run()`` at each stage's chain count
    (``[run_progress_samplers]``): NUTS (Kernel 4), MH (Kernel 5), Gibbs
    (Kernel 6), separable (Kernel 7) and tempering (Kernel 8), the cubes
    equal bit for bit, the same launches and no plain twin.

27. the NUTS stage with x0 > 0 (``[nuts_constrained]``: ``NUTS(...,
    use_pallas="full", transform=CoordinateTransform({0: positive()}))``
    from ``tf.to_x(init)``, ``run(2048, 128)`` twice): the gates of 9 on
    the truncated Gaussian's exact moments, x0 > 0, Kernel 4's transformed
    instance once a step; then ``[k1234_transformed]``: a counted
    ``use_pallas=True`` run (Kernel 3), ``HMC(transform=)`` blocks on
    4,096 chains (Kernels 1 and 2), each transformed instance against its
    twin (Kernel 1 at L = 8 and 192, Kernel 2 at K = 16, L = 8, Kernel 3
    at j = 0..5, Kernel 4 one step), Kernel 4's ``Whitened<Transformed>``
    instance from ``reconditioned("diag")``, and their times;
28. ``neal_funnel(3.0)`` at D = 4 on 16,384 chains (``[funnel_kernels]``):
    Kernel 4 one step and Kernel 3 at j = 0..3 against their twins, a
    ``NUTS(use_pallas="full")`` ``run(256, 256)`` with every draw finite
    and its divergences, and the times;
29. the separable shape constrained (``[sep_constrained]``:
    ``positive()`` on all 10,000 coordinates of the standard normal, 1,024
    chains from x = 1, eps 0.04, L = 40, ``run(128, 128)`` twice on both
    tiers): the half-normal's moments, x > 0, R-hat, the ESS floor, the
    speedup over the plain tier, Kernel 7's transformed fused step 256
    times a run, the recorded row's map ``to_x``; then one step against
    the twins on a mixed table and under a diagonal metric (the scaled
    transformed instance), and the times;
30. eight schools' NUTS half (``[eight_schools]``, bench.py:1259-1341) on
    the lockstep tier, which runs no kernel: ``warmed_up(300, "diag")``,
    ``run(64, 256)`` (the whitened step size's adaptation) and the timed
    ``run(1024, 256)``, the bench's gates, leapfrogs per draw and ESS/s.

31. the MH stage with x0 > 0 (``[mh_constrained]``: ``MetropolisHastings(
    ..., use_pallas="full", transform=CoordinateTransform({0:
    positive()}))``, 65,536 chains, K = 16, ``run(2048)`` twice): x0's
    half-normal moments, x1 ~ N(0, 1), R-hat, the MH stage's ESS floor,
    x0 > 0, Kernel 5's transformed instance 128 times a run, the recorded
    row's ``to_x`` on [65536, 2]; that instance against its twin and the
    times (``[mh_kernel]``, ``[mh_constrained_times]``);
32. the tempering stage under ``interval(-24, 24)`` (``[pt_constrained]``,
    cold scale 0.1 in y): the four gates, every draw inside the interval,
    Kernel 8's transformed instance 128 times a run; that instance against
    its twin and the times (``[pt_kernel_transformed]``);
33. bench.py's four lockstep samplers at their stages' sizes, no kernel
    (``[chees]``/``[chees_adapted]``, ``[ensemble]``, ``[slice]``,
    ``[elliptical]``: bench.py:777-820, 822-856, 911-942, 944-1002):
    warm-up, a burn-in run (the slice's 256 sweeps, the elliptical
    stage's 1,024 steps) and the timed run,
    each stage's gates, ESS/s,
    draws/s, the host's loop tests a step and the idle share of a profiled
    128-step run;
34. eight schools' ChEES half (``[eight_schools_chees]``,
    bench.py:1342-1372): ``warmed_up(500)``, ``run(1024, 256)`` twice, the
    bench's moment gates, leapfrogs a draw, ESS/s;
35. bench.py's evidence and SG-MCMC stages at full size, no kernel:
    ``[ais]`` (65,536 particles, 64 rungs x 2 MH steps: the analytic log-Z
    and weight-ESS gates, particle updates/s, no device-to-host read),
    ``[smc]`` (the same target, target ESS 0.8: completion and log-Z
    gates, stages, reads a stage), ``[sgld]`` and ``[sghmc]`` (the
    conjugate regression's 65,536 rows, B = 1,024, 4,096 chains: the
    analytic posterior gates, draws/s, minibatch rows/s) and ``[psgld]``
    (the 100x anisotropic Gaussian: variance and equalization gates), each
    with its device operations a rung, stage or step and the idle share
    of a profiled call.
36. the run tooling (``checkpoint.py``, ``io/``, ``utils``): after the
    flagship's timed run, ``[checkpoint_flagship]`` saves it
    (``save_sampler``), continues ``run(1024)`` and restores the
    checkpoint into a flagship from another seed for the same run: the
    cubes and states bit for bit, Kernel 2's 64 launches in each, the save
    and restore milliseconds and the file's bytes; ``[checkpoint_device]``
    loads that checkpoint with ``device="cpu"`` into a CPU flagship (the
    state bit for bit; ``load_checkpoint``'s default device is the card);
    ``[trace]`` runs one flagship ``run(1024)`` inside
    ``utils.profiling.trace``, timed by ``utils.time_blocked``: the trace
    file parses as JSON and names Kernel 2. ``[io]`` writes the flagship
    cube's first 512 chains x 2,048 draws from the card with the native
    and the Python CSV writer (each parsed back equal to the cube, rows/s
    of each), and Arrow and Parquet where ``pyarrow`` imports (read back;
    a streamed Parquet file equal to the one-shot export); where it does
    not, each of its exports must raise ``RuntimeError``
    (``pyarrow: absent``).
    ``[checkpoint_nuts]`` continues the adapted NUTS stage (131,072
    chains) ``run(128)`` both ways (the cubes, epsilon, h_bar, m and the
    divergences bit for bit, Kernel 4's 127 launches in each) and
    restores the dense-metric sampler's checkpoint into an unmetriced
    NUTS, which raises; ``[checkpoint_kernels]`` continues one block both
    ways of the MH, Gibbs, separable (16 steps), tempering and
    constrained-MH stages' samplers (Kernels 5, 6, 7, 8 and 5's
    transformed instance, counted), and restores the constrained
    checkpoint into an untransformed MH, which raises.
37. user densities in Kernels 1-4 (``ops/kernels/user_density.py``), on
    eight schools (D = 10) in its three CUDA forms: the hand-written
    ``cuda_source``, the same logp with the gradient of dual numbers
    (``derive_grad_dc``) and the C++ generated from ``logp_batch``. The
    build of 2 compiles their six libraries (each form plain and under a
    diagonal metric) with the built-in one, every ``nvcc`` at once;
    ``[user_build]`` gives each library's nvcc seconds and each user
    instance's registers, stack frame and spills (none may spill);
    ``[user_probe]`` each form's compiled logp and gradient against the
    batch form and autograd on 4,096 rows (``validate_dc_forms`` must
    pass); ``[eight_schools_fused]``, ``[eight_schools_fused_derived]``
    and ``[eight_schools_fused_traced]`` the bench's fused NUTS stage
    (bench.py:1376-1447: 4,096 chains, seed 35, target_accept 0.9,
    ``warmed_up(300, "diag")``, an untimed ``run(1024, 256)``, then the
    best of three timed ``run(1024, 256)``, bench.py's ``_timed_best``,
    the forms in turns) with each form: the moment gates, R-hat, the ESS
    floor, the divergence rate, Kernel 4's whitened user instance once a
    step, µs a step and ESS/s, the derived and traced forms at least 0.7
    times the hand-written ESS/s; ``[user_kernels]`` each user instance of Kernels
    1-4 (Kernel 1 at L = 8, Kernel 2 at K = 16 and L = 8, Kernel 3 at
    j = 4, Kernel 4 one step; plain and whitened) against its twin at the
    hand stage's equilibrium, with its time by CUDA events and alone
    under the profiler (``[k4_user_alone]``: Kernel 4's grid at D = 10,
    its deepest chain, each instance's device µs and the hand stage's
    idle share over a profiled ``run(64, 0)``), and
    ``[user_tier_run]`` the ``use_pallas=True``
    and ``"full"`` HMC tiers and the ``use_pallas=True`` NUTS tier on the
    hand form, counted. The lockstep eight-schools NUTS half (30) times
    ``run(128, 64)``, not 1,024 draws, to leave room for these phases.
38. user forms in Kernels 5-8 (``examples/user_forms.py``), at bench.py's
    stage sizes, each stage one warm-up run and one counted, timed run
    (``counted_run``: the user instance's launches, no twin). The build of 2
    compiles their 15 libraries (value-only: Kernels 5 and 8 with the
    probes, for each user density and for the built-in Gaussian2D beside
    each user proposal; the Gibbs library of the user mixture; Kernel 7's
    of each coordinate functor and wrapper bits) in the same batch;
    ``[user_build]`` their nvcc seconds and registers (none may spill).
    ``[mh_user]``: the MH stage with Gaussian2D as a user Target, traced
    and as a hand ``cuda_source`` copying ``targets.cuh:Gaussian2D``,
    beside the built-in from the same seed: bench.py's four gates, Kernel
    5's 128 launches a run, the hand cube the built-in's bit for bit, the
    traced decisions the built-in's on 99.9% of chains; then
    examples/rosenbrock_mh.py's density traced, a run and one K-block
    against its twin; then Kernel 5's user instance at D = 5 and 16 (past
    D = 3 it takes the accept's logf before the proposal) one K-block
    against its twin each. ``[mh_user_proposal]``: the isotropic walk as a user
    source (its cube the built-in's bit for bit) and a per-coordinate
    scale walk (gates, one block against its twin). ``[pt_user]``: the
    tempering stage on bench's own ``logaddexp`` density, traced and hand:
    bench.py's four gates, 128 launches a run, one block against the twin
    each, and Kernel 8's user instance at D = 5 against its twin (normals
    past D = 2 from draws p T + t). ``[gibbs_user]``: the Gibbs stage with
    the mixture as a user conditional: bench.py's gates, 256 launches a
    run, its cube the built-in's bit for bit, one block against its twin.
    ``[sep_user]``: the separable stage with the standard normal as a plain
    user Target (the coordinate functor generated from its batch form):
    the gates, 256 fused launches a run, decisions the built-in's on 99.9%
    of chains; the logistic with scales logspace(-0.5, 0.5, D) through the
    hand ``cuda_coord_source`` and the derived route (gates on z = x / s,
    acceptance in [0.6, 0.95], the fused step against its float32 and
    float64 twins), and one step each of its Scaled and TransformedCoord
    instances. Each user instance's device time alone, time by events and
    twin time; the kernels line lists them (``k5678_user_records``).
39. the last state dtypes the JAX kernels take: float64 through Kernel 1
    and int32 user forms in Kernel 5. The build of 2 adds Kernel 1's 28
    float64 built-in instances (``mm_leapfrog_f64``) and, in the same
    batch, the float64 libraries of the D = 5 user density (hand and
    traced; ``[f64_ptxas]``: every float64 instance's registers, stack
    frame and spills, reported) and the int32 value-only libraries.
    ``[f64_leapfrog]``: Kernel 1's float64 instances against the float64
    twin per chain (1e-9 of the row's largest entry) at 65,536 chains:
    the flagship (Rosenbrock D = 3, L = 192, reported, and L = 8), the
    MALA path's L = 1 at D = 2, a diag metric, positive() on x0, the
    funnel at D = 4 and the D = 5 user density, hand and traced; each
    case's device time alone beside the float32 instance's and the bound
    at the FP64 rate. ``[f64_hmc_tier]``: ``HMC(rosenbrock_nd(), float64
    init, use_pallas=True, jitter=0.3)`` at the flagship's shape,
    2 x 2,048 draws, the x0 moments against quadrature, float64 cube and
    state, no twin; the float32 tier beside it, and both idle shares.
    ``[f64_mala_tuned]``: the tuned-MALA stage at float64 on
    ``use_pallas=True`` (``tuned(256)``, ``run(2048, 0)`` twice, its
    gates). ``[f64_samplers]``: tests/test_float64.py's samplers, steps
    and gates on the card at float64, their plain tiers, at 4,096 chains. ``[mh_user_int32]``: the Poisson
    stage (65,536 chains, K = 10, ``run(200, 100)``) through the hand
    Poisson source, the traced binomial(10, 0.3) and the user int walk,
    each counted (30 user launches a run), the hand and walk cubes the
    built-in's bit for bit, the pmf gates, one K-block each against its
    twin. The kernels line gains ``leapfrog_trajectory_f64`` and the
    ``mh_multistep_user_int32_*`` records.
40. ``[examples]``: the port's examples (``mini_mcmc_torch/examples/``,
    one per mesh-free script of ``examples/``), each ``main(device=
    "cuda")`` at its own defaults in turn, a line each with its wall
    seconds and its return value; its asserts are the example's own.
    Each example's launches are counted: ``bigd_separable_hmc`` runs
    1,024 chains x D = 10,000 on ``use_pallas="separable"``, Kernel 7's
    fused step 128 times a half (the transformed instance in the
    constrained half), and each half's printed moments must lie within
    0.02 of the exact ones (0 and 1; sqrt(2 / pi) and 1 - 2 / pi; every
    draw > 0); the NUTS examples but logistic regression take NUTS's
    fused tier on the card (``examples.nuts_tier``) and launch Kernel 4
    alone (their user libraries, ``example_requests``, built in 2's
    batch); every other example runs the lockstep tiers and launches no
    kernel. Without ``pyarrow`` the two Parquet examples (``gauss_mh``,
    ``streaming_production_run``) are named as not run, for that
    reason. The three mesh examples (``poisson_mh``: Kernel 5's int32
    Poisson instance through a one-rank chain mesh, 3 launches;
    ``sharded_chains``; ``sgld_data_parallel``: ``data_parallel_grad``
    on a one-rank data mesh) run here too.
41. ``[parallel]``: chain and data parallelism (``mini_mcmc_torch.
    parallel``) on the card. The card machine has one GPU, so the mesh
    has one rank: ``chain_mesh()`` starts a one-rank NCCL group. The
    flagship (Kernel 2, ``run(1024)``), the tempering stage (Kernel 8,
    ``run(512)``) and NUTS on ``use_pallas=True`` (Kernel 3, 4,096
    chains, depth 4), each from one seed unsharded and through
    ``shard_sampler_state``: cubes equal bit for bit, the same launches,
    no collective in the fused runs (scalar reductions only in NUTS's
    lockstep loops), the split R-hat and ESS of the sharded cube equal,
    and the wall seconds of each (the one-rank mesh's overhead).
    ``[parallel_split]``: each of Kernels 2-8 launched on chains ``[0,
    s)`` at ``chain0 = 0`` and ``[s, C)`` at ``chain0 = s`` at its main
    path's shape, for ``s = C / 2`` and an odd ``s``: the two launches
    give one launch's outputs bit for bit. ``[parallel_dpg]``:
    ``data_parallel_grad`` on a one-rank data mesh (65,536 rows x 8,
    1,024 chains, B = 4,096): one all-reduce a call (counted), finite,
    the mean over 256 keys at the full-data gradient's scale, its ms a
    call and the all-reduce's alone. ``[parallel_draws]``: a lockstep
    HMC step's draws at 65,536 x 3 and at a 2- and 4-rank shard's share
    (the global shape every shard draws). Kernels 2-8 at ``chain0`` =
    1,000,003 against their twins by the checks of 6, 9, 10, 16 and 22
    (lines ``*_chain0``).
42. ``[state_mesh]``: the state dimension over a ``"state"`` axis
    (``chain_state_mesh``, ``shard_sampler_state(...,
    shard_state_dim=True)``) on a one-rank ``1 x 1`` NCCL mesh (the card
    machine has one GPU; the multi-rank split runs on the CPU's gloo
    ranks, ``tests/test_torch_state_mesh.py``): the separable stage's
    1,024 x 10,000, L = 10 sampler from one seed unsharded and split, its
    cubes and Kernel 7's launches equal bit for bit (a state axis of one
    rank takes the fused form, no collective); lockstep HMC
    (``use_pallas=False``) at the same shape the same way, and so
    lockstep MH ``run(16, 0)`` (an isotropic walk, 0.024), SGLD ``run(16,
    0)`` (a standard normal's gradient) and NUTS ``run(4, 4)`` (tree
    depth at most 6; only its chain axis's scalar loop exits
    communicate), and the lockstep legs ChEES-HMC ``run(16, 0)`` (step
    0.2, T = 1), elliptical slice ``run(16, 0)`` (a scalar prior) and
    plain tempering ``run(16, 0)`` (4 rungs, 0.024) at 1,024 x 10,000,
    the ensemble ``run(16, 0)`` at 1,024 x 512 (one ensemble) and the
    slice sweep ``run(2, 0)`` at 256 x 64 (the slice and elliptical
    loops' chain-axis scalars alone communicate), each path's seconds.
    ``[state_mesh_split]``: Kernel 7's trajectory form on one state whole
    and split into 2 and 4 D-slices (``d0`` = 0, 5,000 and 0, 2,500,
    5,000, 7,500), on the standard normal and the sigma table: the
    slices' positions concatenated equal the one launch's bit for bit,
    their summed energies within 1e-5 relative, each slice held to its
    float64 twin at its ``d0`` as the fused step's checks hold positions
    and sums; the phase's seconds (at most 45).
42b. ``[state_mesh_ranks]``: a split over two ranks on the one card (two
    spawned processes in a gloo group on CUDA tensors,
    ``chain_state_mesh(1, 2)``): the separable and lockstep samplers of
    42 at 1,024 x 10,000, L = 10, split against unsharded: each rank's
    block of the cube (D-slice 0 or 5,000) equal to the unsharded cube's
    bit for bit on at least 99% of chains (the energies are summed in
    another order, so a chain whose accept test is within rounding of its
    uniform may decide the other way), every shard of a chain moving in
    the same steps, each chain that differs differing first at a step
    where one run accepted and the other did not (no run discards, so
    every step is seen), the separable run two-pass Kernel 7 launches one a
    step and the lockstep run none, one all-reduce a step among the
    port's own collectives (``parallel.collectives``) and none of another
    kind. Then MH ``run(16, 0)``, SGLD ``run(16, 0)`` and NUTS ``run(4,
    0)`` of 42 in float32 the same way (SGLD bit for bit on every chain;
    a NUTS chain may also differ first by a jump, a flipped merge), and
    NUTS ``run(4, 4)`` on float64 states within 1e-6 of unsharded on every
    chain and its step sizes within 1e-6 (its dual averaging amplifies
    the sums' rounding, so no float32 chain stays bit for bit under
    adaptation); every shard of a chain holding the same step sizes; no
    kernel; MH two all-reduces a step (DTensor's: the logp and both q
    terms), SGLD none, NUTS between one and two of the port's state-axis
    sums a target evaluation besides the chain axis's scalars; each
    path's seconds. Then the lockstep legs of 42 the same way (a slice,
    elliptical or tempering chain may also differ first by a jump: both
    runs move), their global ``dim``, no kernel, and their collectives a
    step: ChEES-HMC one of the port's all-reduces (its logp a share, its
    gradient elementwise), the ensemble two and tempering one of
    DTensor's, slice and elliptical one of DTensor's a density evaluation
    besides the chain axis's scalars; and ChEES ``warmed_up(16)`` on
    float64 states at 1,024 x 10,000 (``[state_mesh_ranks]
    path=lockstep_chees_warmed``): step size and trajectory length within
    1e-6 of unsharded and the same on both ranks, positions within 1e-6;
    within 240 s.

The second-to-last line is a JSON object with one record per kernel
(time, plain time, least possible time ``bound_ms`` and what bounds it,
launches on the main paths); the last line is ``{"ok": true, "device":
{...}}``. Without CUDA the script raises at once and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

import mini_mcmc_torch as mt
from mini_mcmc_torch.checkpoint import restore_sampler, save_sampler
from mini_mcmc_torch.ops.kernels import _build, rng, user_density
from mini_mcmc_torch.ops.kernels.gibbs_full import (
    gibbs_multistep,
    gibbs_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.hmc import (
    leapfrog_trajectory,
    leapfrog_trajectory_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_full import (
    hmc_multistep,
    hmc_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.hmc_sep import (
    accept_uniforms,
    hmc_separable,
    hmc_separable_plain,
    hmc_separable_step,
    hmc_separable_step_plain,
    sep_fused,
)
from mini_mcmc_torch.ops.kernels.mh_full import (
    mh_multistep,
    mh_multistep_plain,
)
from mini_mcmc_torch.ops.kernels.nuts_full import nuts_step, nuts_step_plain
from mini_mcmc_torch.ops.kernels.nuts_subtree import subtree, subtree_plain
from mini_mcmc_torch.ops.kernels.pt_full import (
    make_ladder,
    pt_multistep,
    pt_multistep_plain,
)
from mini_mcmc_torch.utils.profiling import (ProfilerDroppedEvents,
                                             device_profile)

# the flagship configuration of bench.py:64-92
N_CHAINS = 65536
DIM = 3
STEP_SIZE = 0.02
N_LEAPFROG = 192
N_COLLECT = 8192
JITTER = 0.3
STEPS_PER_CALL = 16
ROSEN3D_X0_MEAN = 0.785217  # quadrature, bench.py:91-92
ROSEN3D_X0_VAR = 0.229370
# Kernels 1 and 2's whitened instances against their twins: a few thousand
# of the flagship's chains
WHITENED_CHAINS = 4096

# the NUTS configuration of bench.py:94-105,286-336
NUTS_CHAINS = 131072
NUTS_COLLECT = 2048
NUTS_DISCARD = 128
NUTS_MEAN = (0.0, 1.0)
NUTS_COV = ((4.0, 2.0), (2.0, 3.0))
NUTS_MAX_DEPTH = 10
NUTS_STEPS = NUTS_COLLECT + NUTS_DISCARD - 1  # the NUTS convention
# NUTS kernels against their twins: discrete choices (slice counts,
# U-turns, accepts) follow float comparisons that one ulp can flip, so
# the gate is a per-chain share; values within rtol 1e-4 / atol 1e-5
NUTS_RTOL, NUTS_ATOL = 1e-4, 1e-5
NUTS_SHARE = 0.999

# the MH and Gibbs stages of bench.py:391-525
MH_CHAINS = 65536
MH_COLLECT = 2048
MH_K = 16
POISSON_LAM = 4.0
POISSON_COLLECT, POISSON_DISCARD, POISSON_K = 200, 100, 10
GIBBS_COLLECT = 8192
GIBBS_K = 32
MIX = (-2.0, 1.0, 3.0, 1.5, 0.5)  # mu0, sigma0, mu1, sigma1, pi0
# Kernels 5 and 6 against their twins: the draws and the proposals round
# alike, the target's logp may differ by an ulp (FMA contraction in the
# Gaussian functor, lgammaf), and an accept or z draw on such a tie flips,
# so the gate is a per-chain share; values within rtol 1e-5 / atol 1e-6
MH_RTOL, MH_ATOL = 1e-5, 1e-6
MH_SHARE = 0.999

# the large-D HMC stage of bench.py:553-700
SEP_CHAINS, SEP_DIM, SEP_COLLECT, SEP_L, SEP_EPS = 1024, 10_000, 128, 10, 0.1
SEP_L40, SEP_EPS40, SEP_COLLECT40 = 40, 0.05, 32
SEP_DIAG_DIM = 1024  # R-hat and ESS on the contiguous [128, 1024, 1024]
# Kernel 7 against its twin: the three per-chain sums at rtol 1e-5, the
# fused step's alpha_c against the float64 twin's at 1e-2 absolute
SEP_SUM_RTOL = 1e-5
SEP_ALPHA_ATOL = 1e-2

# the tempering stage of bench.py:858-909
PT_CHAINS, PT_COLLECT, PT_TEMPS, PT_K = 8192, 2048, 8, 16
PT_W_PLUS = 0.7

# the tuned MALA stage of bench.py:732-779 (bench_beyond's first)
MALA_CHAINS, MALA_COLLECT, MALA_K, MALA_ADAPT = 65536, 2048, 16, 256
MALA_MEAN, MALA_VAR = (0.0, 1.0), (4.0, 3.0)
# the MH stage's configuration (bench.py:391-431) from a 25-sigma walk,
# its scale tuned; the move-rate band of tests/test_mh.py:160-167
MH_TUNED_STD, MH_TUNED_ADAPT = 25.0, 256
# the separable stage's shape (bench.py:553-560) on a normal with
# sigma_d = logspace(-1, 1, D), warmed_up(128, "diag")
SEP_WARM_ADAPT = 128

# the NUTS stage with x0 > 0 (transform=): CoordinateTransform({0:
# positive()}); the exact moments of N([0, 1], [[4, 2], [2, 3]]) truncated
# to x0 > 0: x0 is half-normal of scale 2, x1 | x0 ~ N(1 + x0 / 2, 2)
TRUNC_MEAN = (2.0 * math.sqrt(2.0 / math.pi), 1.0 + math.sqrt(2.0 / math.pi))
TRUNC_VAR = (4.0 * (1.0 - 2.0 / math.pi), 3.0 - 2.0 / math.pi)
# its steady-state divergences: the unconstrained stage's C / 10,000 does
# not hold for this posterior in either package. Under positive() the
# upper tail of x0 becomes an exponential wall in y = log x0, which a
# trajectory at the adapted step (~0.48) meets with an energy error past
# the divergence threshold: the JAX package diverges on 2.5e-4 of its
# transitions there (2,048 chains, run(256, 64) twice, its lockstep NUTS
# on the CPU), the port's Kernel 4 twin on 2.4e-4
# (tests/measure_transform_stages.py). The gate is four times the JAX
# rate, a divergence per thousand transitions
TRUNC_DIVERGENCE_RATE = 1e-3
# Kernels 1 and 2's transformed instances: an HMC block on a few thousand
# of that stage's chains, a step the x0 ~ 8 tail takes stably
K12_TRANSFORMED_CHAINS, K12_TRANSFORMED_EPS = 4096, 0.2
# Neal's funnel (models/gaussian.py:neal_funnel) at D = 4
FUNNEL_CHAINS, FUNNEL_DIM, FUNNEL_SCALE, FUNNEL_RUN = 16384, 4, 3.0, 256
# the separable stage's shape constrained (examples/bigd_separable_hmc.py:
# 41-46): positive() on all D coordinates of the standard normal from
# x = 1; x is half-normal: E = sqrt(2 / pi), Var = 1 - 2 / pi. The
# example's eps 0.22, L = 8 accepts no step at D = 10,000 in either
# package (from x = 1 a trajectory's energy error is -80; eps 0.04 gives
# -0.6), and L = 40 makes the chains mix within the stage's two runs
# (tests/measure_transform_stages.py)
SEP_C_EPS, SEP_C_L = 0.04, 40
SEP_C_MEAN, SEP_C_VAR = math.sqrt(2.0 / math.pi), 1.0 - 2.0 / math.pi
# eight schools' NUTS half (bench.py:1259-1341): 4,096 chains, D = 10,
# target_accept 0.9, warmed_up(300, "diag"), run(1024, 256) twice
ES8_CHAINS, ES8_COLLECT, ES8_DISCARD, ES8_ADAPT = 4096, 1024, 256, 300
# its lockstep first run re-adapts the step size in the whitened space
# over its discarded steps and then collects 64 draws, not 1,024: the draws of
# that run are not gated, and the cut keeps the script within its time
# budget (~60 s of the lockstep tier's host calls)
ES8_FIRST_COLLECT = 64
# its ChEES half (bench.py:1342-1372): warmed_up(500), the same runs
ES8_CHEES_ADAPT = 500
# the lockstep NUTS half's timed run collects 128 draws after 64, not the
# bench's 1,024 after 256 (its gates scale with the draws: the ESS floor
# is 0.002 C n), after warmed_up(100) and a first run re-adapting over
# 64 discarded steps: at 109-250 ms a step on an H100 80GB HBM3 at 700 W
# (113-183 s for the stage at warmed_up(150), run(64, 128), run(256, 128))
# it is the slowest stage of the script, and the fused stages below run
# the bench's full warmed_up(300) and run(1024, 256) on the same posterior
ES8_NUTS_COLLECT, ES8_LOCKSTEP_DISCARD, ES8_LOCKSTEP_ADAPT = 128, 64, 100
# eight schools on the fused NUTS tier (bench.py:1376-1447): Kernel 4's
# user instances, seed 35, warmed_up(300, "diag"), run(1024, 256) twice,
# the second timed, with each of the three CUDA forms of the target
ES8_FUSED_SEED = 35
ES8_FORMS = ("hand", "derived", "traced")
# the derived gradient's ESS/s against the hand-written one's
# (bench.py:1437-1438)
ES8_DERIVED_RATE = 0.7

# the MH and tempering stages under a transform: x0 > 0 on the MH stage
# (x0 half-normal: E = sqrt(2 / pi), Var = 1 - 2 / pi), interval(-24, 24)
# on the tempering stage at a cold scale of 0.1 in y: dx/dy ~ 10.7 at the
# modes, so 0.1 in y is about the bench's 1.0 in x (1.0 in y passes the
# gates too; tests/measure_transform_stages.py, both packages)
HALF_NORMAL_MEAN = math.sqrt(2.0 / math.pi)
HALF_NORMAL_VAR = 1.0 - 2.0 / math.pi
PT_C_STD = 0.1
# bench.py's bench_beyond stages of the four lockstep samplers (no kernel):
# ChEES-HMC (:777-820), the ensemble (:822-856), coordinate slice
# (:911-942) and elliptical slice (:944-1002)
CHEES_CHAINS, CHEES_COLLECT, CHEES_ADAPT = 65536, 2048, 256
ENS_CHAINS, ENS_COLLECT, ENS_WALKERS, ENS_K = 65536, 2048, 64, 16
# the slice stage collects 512 draws and the elliptical 1,024, not
# bench.py's 2,048 (their gates scale with the draws), to make room for
# the examples: 46 and 24 s for 2,048 on an H100 80GB HBM3 at 700 W, and
# slice 29-53 s for 1,024
SLICE_CHAINS, SLICE_COLLECT, SLICE_K = 65536, 512, 16
# the slice stage's burn-in: 256 sweeps, not bench.py's 2,048 (its burn
# compiles XLA too): the chains mix in ~5 sweeps (ESS 0.21 a draw on the
# H100) and each sweep costs ~18 ms of host calls
SLICE_BURN = 256
GP_DIM, GP_CHAINS, GP_COLLECT, GP_K, GP_NOISE = 64, 4096, 1024, 16, 0.3
# the elliptical stage's burn-in: 1,024 steps, not bench.py's 2,048 (~11 s
# of host calls a 1,024): six of its slowest coordinates' autocorrelation
# times (ESS 0.006 a draw on the H100) from the prior mean
GP_BURN = 1024
# the steps of a profiled run that reads these stages' idle share (32: the
# profiler's own overhead on their many small operations costs tens of
# seconds a stage at 128)
LOCKSTEP_PROFILE = 32
# bench.py's evidence stages (:1003-1076): the unnormalized correlated
# Gaussian2D (the NUTS stage's covariance), 65,536 particles, a N(0, 2.5^2)
# prior, random-walk scale 1.0; AIS 64 linear rungs x 2 MH steps, SMC 5
# sweeps a stage at target ESS 0.8
EV_PARTICLES, AIS_RUNGS = 65536, 64
AIS_KW = dict(n_mh_steps=2, proposal_std=1.0, prior_std=2.5)
SMC_KW = dict(proposal_std=1.0, prior_std=2.5)
# its SG-MCMC stages (:1078-1138, 1189-1257): the conjugate regression's
# N rows, D, minibatch B, chains, steps a run and block K; the noise and
# prior scales; pSGLD's D and its burn-in (twice the run)
SG_ROWS, SG_DIM, SG_BATCH, SG_CHAINS, SG_STEPS, SG_K = (65536, 8, 1024,
                                                        4096, 2048, 16)
SG_NOISE, SG_TAU = 0.5, 2.0
PS_DIM = 8
# best of this many timed calls, as bench.py:_timed_best
TIMED_REPS = 3
# the run tooling's phases: the flagship's and the NUTS stage's
# continuations after a checkpoint, and the exported sub-cube (the
# flagship cube's first 512 chains x 2,048 draws, 1,048,576 rows)
CKPT_FLAGSHIP_RUN, CKPT_NUTS_RUN, CKPT_SEP_RUN = 1024, 128, 16
IO_CHAINS, IO_DRAWS = 512, 2048

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes over 3.35 TB/s and its operations over the issue
# rate. Operations are lane instructions counted from the CUDA sources
# (an FMA is one; estimates, listed below); one instruction per lane per
# clock is the 67 TFLOP/s FP32 peak with an FMA as two flops, so the rate
# is 33.5e12 a second. Integer work (Philox, the hash) issues at no more
# than that rate. Random draws are counted as the least the work needs,
# not as the kernels lay them out (rng_ops): a word per uniform or coin,
# two words and half a Box-Muller pair per normal, four words per Philox.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 67e12 / 2
OPS = {
    "rosen3d_leapfrog": 21,  # 12 gradient + 9 momentum/position FMAs
    "philox_draw": 83,  # 10 rounds x 8 (2 mul.hi, 2 mul.lo, 2 3-way xor,
                        # 2 key adds) + the unit map
    "box_muller": 35,  # logf, sqrtf, cosf and their arithmetic
    "box_muller_pair": 45,  # logf, sqrtf, sincosf: two normals
    "hmc_step": 40,  # logp, the energies, the accept's logf
    "nuts_leaf": 56,  # leapfrog, logp, joint, checks, expf, row push
    "nuts_merge": 35,  # swap ratio (a division), U-turn dots, row merge
    "hash_draw": 22,  # nuts_tree.cuh:hash_unit
    "nuts_doubling": 34,  # end selects and updates, ratio, outer U-turn
    "nuts_step": 50,  # gradient, logp, joint, loads, stores, warp max
    "mh_step": 30,  # logf(u), the accept, selects, the history row
    "gauss2d_logp": 10,  # the quadratic
    "isotropic_propose": 2,  # a multiply and an add per coordinate
    "int_walk_propose": 5,  # coin, add, the two clamps
    "poisson_logp": 8,  # a table read of lgamma(k + 1), the product, two
                        # subtractions, the k < 0 and table-size selects
                        # (lgammaf, priced 45 before the table, is 27-54
                        # SASS instructions a lane at k + 1 <= 11)
    "mixture_sweep": 60,  # two expf, a division, selects, the x draw
    "sep_leapfrog": 2,  # per coordinate: the drift and the kick FMAs (the
                        # standard normal's derivative folds into the kick)
    "sep_coord": 8,  # first half kick, the three sums, load and store
    "mixture1d_logp": 45,  # two divisions, the squares, expf, log1pf
    "pt_update": 22,  # proposal, the accept's logf, product and selects
    "pt_swap": 25,  # logf, the product, compare, four selects, the EWMA
    "affine_d2": 6,  # a whitened density at D = 2: x = L y (3 FMAs) and
                     # g_y = L^T g_x (3), D (D + 1) / 2 each
    "gauss2d_leapfrog": 12,  # the two kicks and the drift (6 FMAs), the
                             # gradient (2 subtractions, 4 FMAs)
    "sep_leapfrog_scaled": 3,  # per coordinate: the drift and the kick
                               # FMAs and the gradient's product by the
                               # coordinate's -(s / sigma)^2
    "sep_scaled_coef": 6,  # per coordinate once: (s / sigma)^2, a
                           # division (a reciprocal and its Newton step)
                           # and two products
    "sep_accept": 30,  # per chain: the tiles' sums, logf(u), the compare,
                       # expf and the selects of the fused step
    "affine_d3": 12,  # a whitened density at D = 3: x = L y and g_y =
                      # L^T g_x, D (D + 1) / 2 FMAs each
    "bij_grad": 16,  # a constrained coordinate's x, dx/dy and dld/dy in
                     # the core (targets.cuh:bij_grad): |y|, the compare,
                     # expf (range reduction, MUFU.EX2, scaling), the
                     # products and the chain rule's FMA
    "bij_logp": 14,  # its x and log-Jacobian: the same expf and an add
    "bij_identity": 2,  # an identity coordinate's code compare
    "funnel4_grad": 24,  # the funnel's gradient at D = 4: expf, the sum of
                         # squares, five products
    "funnel4_leapfrog": 16,  # the kicks and drifts of four coordinates
    "bij_logp_interval": 40,  # an interval coordinate's x and log-Jacobian
                              # (targets.cuh:bij_logp): the core compare,
                              # the sigmoid's expf and reciprocal, log1pf,
                              # logf(w) and the adds
    # eight schools at D = 10 (examples/eight_schools.py:CUDA_SOURCE)
    "es8_logp": 145,  # expf and log1pf of tau, per school theta, the
                      # residual, its square over sigma^2 (a division)
                      # and eta's square, the sums
    "es8_grad": 120,  # the hand-written gradient: expf, t2 and its
                      # division, per school the residual over sigma^2
                      # (a division) and three FMAs
    "d10_leapfrog": 30,  # the kicks and drift of ten coordinates
    "d10_leaf_rest": 60,  # the joint (ten FMAs), the checks, expf and the
                          # leaf row's 3D + 1 shared-memory stores
    "d10_merge": 75,  # the U-turn dots (2D FMAs), the row's loads and the
                      # proposal's copy, the swap ratio
    "d10_doubling": 100,  # six D-wide end selects, the outer U-turn dots
    "diag_d10": 20,  # x = s y and g_y = s g_x: D products each
    # the user forms of Kernels 5-8 (38)
    "banana_logp": 12,  # examples/rosenbrock_mh.py's density: two
                        # differences, three squares, the sum, the scale
    # the least work of a user form: a division by a constant of the
    # density is a product by its reciprocal, taken once where the
    # constant is (a coordinate's in Kernel 7, a chain's in a launch)
    "rcp": 4,  # a reciprocal: MUFU.RCP, its Newton step's two FFMAs and
               # the product that rounds it
    "gauss_coord_logp": 2,  # a Gaussian coordinate of hoisted reciprocal
                            # standard deviation: the product and the
                            # FFMA of its square into the sum
    "logistic_grad": 18,  # -tanh(x r / 2) r, r = 1 / s a coordinate's
                          # constant: tanhf (|x|, the range compare,
                          # MUFU.EX2 and MUFU.RCP with their FMAs above
                          # 0.6, a five-term odd polynomial below, the
                          # select and the sign: 16) and two products
    "logistic_coef": 5,  # per coordinate once: r = 1 / s (rcp) and r / 2
    "logistic_logp": 53,  # |x| r (a product), expf (8), log1pf (22), logf
                          # (s) (20), the doubling and the adds
    "bij_grad_interval": 30,  # an interval coordinate's x and dx/dy: the
                              # sigmoid's expf and reciprocal, products
}


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by) for ``n_bytes`` moved and ``n_ops`` issued."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ISSUE_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def rng_ops(normals, uniforms):
    """The least lane instructions that draw ``normals`` normals and
    ``uniforms`` one-word uniforms or coins for one chain: normals in
    Box-Muller pairs (sine and cosine of one angle, two words), and
    ``ceil(words / 4)`` Philox-10 evaluations. ``uniforms`` may be a
    per-chain tensor (data-dependent draws); the result then is too."""
    pairs, single = divmod(normals, 2)
    words = 2 * (pairs + single) + uniforms
    evals = (torch.ceil(words / 4) if torch.is_tensor(words)
             else math.ceil(words / 4))
    return (evals * OPS["philox_draw"] + pairs * OPS["box_muller_pair"]
            + single * OPS["box_muller"])


# Kernel-versus-plain tolerance on stable trajectories, as
# tests/test_pallas.py:56 holds the TPU kernel: the kernel contracts
# multiply-adds into FMAs and the plain version does not, a difference of
# about one f32 ulp per operation that a short trajectory does not grow
# anywhere near 1e-3.
RTOL, ATOL = 1e-3, 1e-4


#: the script's start, for the command seconds each line is printed at
T0 = time.perf_counter()


def say(phase: str, **vals) -> None:
    vals["at_s"] = f"{time.perf_counter() - T0:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in vals.items()),
          flush=True)


def check(name: str, ok: bool, info) -> None:
    if not ok:
        raise AssertionError(f"check FAILED [{name}]: {info}")


def chain_agree(kernel: torch.Tensor, plain: torch.Tensor) -> torch.Tensor:
    """Per chain (axis 0): every component within RTOL/ATOL of the plain
    value, or non-finite in both."""
    ok = (kernel - plain).abs() <= ATOL + RTOL * plain.abs()
    ok |= ~torch.isfinite(kernel) & ~torch.isfinite(plain)
    return ok.reshape(ok.shape[0], -1).all(dim=1)


def grad_agree(kernel: torch.Tensor, plain: torch.Tensor) -> torch.Tensor:
    """:func:`chain_agree` for gradients, the absolute tolerance scaled to
    the chain's largest |g| as ``tests/test_torch_models.py`` scales it:
    the x_{i+1} - x_i^2 cancellation leaves float32 noise of that size near
    a component's zero."""
    scale = plain.abs().amax(dim=1, keepdim=True)
    ok = (kernel - plain).abs() <= ATOL + RTOL * (plain.abs() + scale)
    ok |= ~torch.isfinite(kernel) & ~torch.isfinite(plain)
    return ok.all(dim=1)


def max_abs_err(kernel, plain, mask=None) -> float:
    d = (kernel - plain).abs()
    if mask is not None:
        d = d[mask]
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def device_ms_per_launch(launch, name: str, reps: int = 50):
    """A kernel's device milliseconds a launch alone: ``reps``
    back-to-back launches under ``torch.profiler``, the device time of the
    kernels whose name holds ``name`` over the launches it recorded;
    ``None`` ("not measured") when the profiler delivered none of its
    events in three attempts (utils/profiling.py:device_profile), as
    :func:`device_ms_each` reports it; an error of the launch itself fails
    the run."""
    try:
        _, _, by_name = device_profile(
            lambda: [launch() for _ in range(reps)], expect=name)
    except ProfilerDroppedEvents as e:
        say("device_ms_per_launch", not_measured=name, reason=repr(str(e)))
        return None
    n = sum(c for k, (c, _) in by_name.items() if name in k)
    us = sum(u for k, (_, u) in by_name.items() if name in k)
    check(f"profiled {name} launches", 0 < n <= reps, n)
    return us / n * 1e-3


def device_ms_each(launches: dict, reps: int) -> dict:
    """Each kernel's device milliseconds a launch alone, by kernel name,
    from one ``torch.profiler`` call that launches each of ``launches``
    (name -> launch) ``reps`` times back to back; ``None`` ("not
    measured") for a kernel whose events the profiler did not deliver in
    its three attempts (utils/profiling.py:device_profile); an error of a
    launch itself fails the run."""
    try:
        _, _, by_name = device_profile(
            lambda: [fn() for fn in launches.values() for _ in range(reps)],
            expect=next(iter(launches)))
    except ProfilerDroppedEvents as e:
        say("device_ms_each", not_measured=repr(list(launches)),
            reason=repr(str(e)))
        return dict.fromkeys(launches)
    out = {}
    for name in launches:
        n = sum(c for k, (c, _) in by_name.items() if name in k)
        us = sum(u for k, (_, u) in by_name.items() if name in k)
        out[name] = us / n * 1e-3 if 0 < n <= reps else None
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


#: every kernel wrapper (launch counter) and plain twin (call counter)
KERNELS = {
    "hmc_multistep": hmc_multistep,
    "leapfrog_trajectory": leapfrog_trajectory,
    "nuts_step": nuts_step,
    "nuts_subtree": subtree,
    "mh_multistep": mh_multistep,
    "gibbs_multistep": gibbs_multistep,
    "hmc_separable": hmc_separable,
    "hmc_separable_step": hmc_separable_step,
    "pt_multistep": pt_multistep,
}
TWINS = {
    "plain_multistep_calls": hmc_multistep_plain,
    "plain_leapfrog_calls": leapfrog_trajectory_plain,
    "plain_nuts_step_calls": nuts_step_plain,
    "plain_subtree_calls": subtree_plain,
    "plain_mh_multistep_calls": mh_multistep_plain,
    "plain_gibbs_multistep_calls": gibbs_multistep_plain,
    "plain_hmc_separable_calls": hmc_separable_plain,
    "plain_hmc_separable_step_calls": hmc_separable_step_plain,
    "plain_pt_multistep_calls": pt_multistep_plain,
}


#: the kernels with transformed instances (a transform=, models/
#: transforms.py): each counts those launches in ``transformed_launches``
TRANSFORMED_KERNELS = ("hmc_multistep", "leapfrog_trajectory", "nuts_step",
                       "nuts_subtree", "hmc_separable", "hmc_separable_step",
                       "mh_multistep", "pt_multistep")


#: the kernels with user instances (a Target's cuda_source or the C++
#: generated from its batch form, a user proposal, conditional or
#: coordinate functor: ops/kernels/user_density.py): each counts those
#: launches in ``user_launches``
USER_KERNELS = ("hmc_multistep", "leapfrog_trajectory", "nuts_step",
                "nuts_subtree", "mh_multistep", "gibbs_multistep",
                "hmc_separable", "hmc_separable_step", "pt_multistep")


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in TWINS.values():
        fn.calls = 0
    hmc_separable.scaled_launches = 0
    hmc_separable_step.scaled_launches = 0
    for name in TRANSFORMED_KERNELS:
        KERNELS[name].transformed_launches = 0
    for name in USER_KERNELS:
        KERNELS[name].user_launches = 0
    leapfrog_trajectory.f64_launches = 0


def read_counts() -> dict:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    # Kernel 7's scaled (diagonal-metric) instances, also in its launches:
    # the trajectory-only (two-pass) form and the fused step
    counts["hmc_separable_scaled"] = hmc_separable.scaled_launches
    counts["hmc_separable_step_scaled"] = hmc_separable_step.scaled_launches
    # the transformed instances, also in the kernels' launches
    for name in TRANSFORMED_KERNELS:
        counts[f"{name}_transformed"] = KERNELS[name].transformed_launches
    # the user instances (a user density's own library), also counted there
    for name in USER_KERNELS:
        counts[f"{name}_user"] = KERNELS[name].user_launches
    # Kernel 1's float64 instances, also counted in its launches
    counts["leapfrog_trajectory_f64"] = leapfrog_trajectory.f64_launches
    counts.update({name: fn.calls for name, fn in TWINS.items()})
    return counts


def counts_with(**launches) -> dict:
    """The counts of a run that launched only ``launches``."""
    want = dict.fromkeys(read_counts(), 0)
    want.update(launches)
    return want


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol, the
    namespace prefix cut (``mh_multistep_kernelIN2mm10Gaussian2D...``)."""
    ns = re.match(r"_ZN(\d+)", mangled)  # _ZN <length> <namespace>
    if ns:
        mangled = mangled[ns.end() + int(ns.group(1)):]
    return re.split(r"E+v", re.sub(r"^\d+", "", mangled))[0]


#: kernels whose registers, stack frame and spills phase_build reports,
#: every instance (the whitened ones of Kernels 1-4 included)
PTXAS_KERNELS = ("leapfrog_kernel", "multistep_kernel", "subtree_kernel",
                 "nuts_step_kernel", "pt_multistep_kernel",
                 "mh_multistep_kernel", "gibbs_multistep_kernel",
                 "hmc_separable_kernel")


def ptxas_report(log: str) -> tuple[list, dict]:
    """``ptxas -v`` of a build log: each entry function's registers and
    stack as lines, and the registers, stack frame and spills of the
    PTXAS_KERNELS instances by kernel and template arguments."""
    regs, name, frame = [], "?", {}
    reported = {}
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if spill:
            frame = dict(zip(("frame", "spill_stores", "spill_loads"),
                             map(int, spill.groups())))
        used = re.search(r"Used (\d+) registers.*?(\d+) bytes cumulative"
                         r" stack|Used (\d+) registers", line)
        if used:
            n_regs = used.group(1) or used.group(3)
            regs.append(f"{name[:60]}: {n_regs} regs, "
                        f"{used.group(2) or 0} B stack")
            if name.startswith(PTXAS_KERNELS):
                reported[name] = dict(regs=int(n_regs), **frame)
    return regs, reported


def phase_build(user_requests=()):
    """Build the kernels, and with them the libraries of
    ``user_requests`` (``user_density.jobs``), every ``nvcc`` started
    together; returns the library's path and the registers, stack frame
    and spills of the PTXAS_KERNELS instances by name."""
    t0 = time.perf_counter()
    so = _build.build(also=user_density.jobs(user_requests))
    _build.lib()
    regs, reported = ptxas_report(so.with_suffix(".log").read_text())
    say("build", seconds=round(time.perf_counter() - t0, 3), lib=so.name,
        user_libraries=len(user_requests), ptxas=repr(regs))
    for kernel, info in reported.items():
        say("ptxas_instance", kernel=kernel[:64], **info)
    return so, reported


#: SASS opcodes by what they do in Kernels 5 and 6: the Philox rounds are
#: 32x32 wide multiplies and three-way xors (LOP3), the transcendental
#: functions MUFU plus FP32 arithmetic
SASS_GROUPS = (
    ("mul_wide", ("IMAD.WIDE", "IMAD.HI")),
    ("lop3", ("LOP3",)),
    ("mufu", ("MUFU",)),
    ("fp32", ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK",
              "FRND", "FSWZADD")),
    ("memory", ("LDG", "STG", "LDC", "ULDC", "LDL", "STL", "LD.", "ST.")),
    ("control", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "NOP",
                 "WARPSYNC", "BREAK")),
)
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(so) -> dict:
    """``cuobjdump -sass`` of the library: per kernel (``kernel_name``),
    its instructions as ``(address, opcode, operands)`` and its labels'
    addresses. Raises when ``cuobjdump`` is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found: the SASS cannot be counted")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, insns, labels, pending = {}, None, None, []
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            insns, labels, pending = [], {}, []
            funcs[kernel_name(head.group(1))] = (insns, labels)
            continue
        if insns is None:
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = _SASS_INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(3), m.group(4)))
    return funcs


def sass_step_count(insns, labels, stores_per_step: int) -> dict:
    """The K loop of a multistep kernel in its SASS: the loop (a backward
    branch) that holds the most history stores (STG), its static length,
    steps per iteration (stores / ``stores_per_step``), instructions per
    step in all and by SASS_GROUPS."""
    best = None
    for body in sass_loops(insns, labels):
        stores = sum(op.startswith("STG") for _, op, _ in body)
        if best is None or (stores, len(body)) > (best[0], len(best[1])):
            best = (stores, body)
    if best is None:
        return {"loop": 0}
    stores, body = best
    steps = max(stores // stores_per_step, 1)
    out = {"loop": len(body), "stores": stores, "steps_per_iteration": steps,
           "per_step": len(body) / steps}
    for group, prefixes in SASS_GROUPS:
        n = sum(op.startswith(prefixes) for _, op, _ in body)
        out[group] = n / steps
    out["other_int"] = out["per_step"] - sum(out[g] for g, _ in SASS_GROUPS)
    return out


def sass_loops(insns, labels):
    """The loops of a kernel's SASS: for each backward branch (to a label
    or an address), the instructions from its target to the branch."""
    for addr, op, rest in insns:
        if not op.startswith("BRA"):
            continue
        target = re.search(r"\((\.L_x_\d+)\)", rest)
        hexa = re.search(r"0x([0-9a-f]+)", rest)
        to = (labels.get(target.group(1)) if target
              else int(hexa.group(1), 16) if hexa else None)
        if to is not None and to <= addr:
            yield [i for i in insns if to <= i[0] <= addr]


def sass_leapfrog_loop(insns, labels) -> dict:
    """Kernel 7's leapfrog loop in its SASS: the loop that holds the most
    FFMAs, its length and its FP32 and division opcodes (an IEEE division
    is MUFU.RCP and FCHK, its slow path a CALL)."""
    best = max(([op for _, op, _ in body] for body in sass_loops(
        insns, labels)), key=lambda ops: sum(o.startswith("FFMA")
                                             for o in ops), default=[])
    return {"loop": len(best),
            **{k: sum(o.startswith(k) for o in best)
               for k in ("FFMA", "FMUL", "MUFU", "MUFU.RCP", "FCHK",
                         "CALL")}}


def phase_sass(so, reported) -> None:
    """``--profile``: each Kernel 5 and 6 instance's SASS per step (the
    static K loop, slow paths that the compiler placed inside it included)
    and its registers; each Kernel 7 instance's leapfrog loop, which must
    hold no division (no MUFU.RCP, FCHK or CALL)."""
    for name, (insns, labels) in sass_functions(so).items():
        if name.startswith("hmc_separable_kernel"):
            loop = sass_leapfrog_loop(insns, labels)
            say("sass_k7", kernel=name[:72], instructions=len(insns),
                **reported.get(name, {}), **loop)
            if "TransformedCoord" in name:
                # a bijector's exp and __fdividef are MUFU.EX2 and
                # MUFU.RCP; no IEEE division's slow path (CALL) in a
                # leapfrog
                check(f"no call in Kernel 7's transformed loop "
                      f"({name[:60]})", loop["FFMA"] > 0
                      and loop["FCHK"] == loop["CALL"] == 0, loop)
                continue
            check(f"no division in Kernel 7's leapfrog loop ({name[:60]})",
                  loop["FFMA"] > 0 and loop["MUFU.RCP"] == loop["FCHK"]
                  == loop["CALL"] == 0, loop)
            continue
        if not name.startswith(("mh_multistep_kernel",
                                "gibbs_multistep_kernel")):
            continue
        dim = int(re.search(r"Li(\d+)", name).group(1))
        say("sass", kernel=name[:60], instructions=len(insns),
            **reported.get(name, {}),
            **sass_step_count(insns, labels, dim))


def phase_philox(dev) -> None:
    kat = rng.philox_fill(1, 0, 0, 0, dev).cpu().tolist()[0]
    want = [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    check("philox known answer", kat == want, [hex(w) for w in kat])
    seed = 0x0123456789ABCDEF
    bits = rng.philox_fill(1 << 20, 7, 3, seed, dev)
    plain = rng.philox_fill_plain(1 << 20, 7, 3, seed, dev)
    n_diff = int((bits != plain).sum())
    check("philox bits", n_diff == 0, f"{n_diff} words differ")
    say("philox", known_answer="ok", counters=1 << 20, words_differing=0)


def hmc_gates(sample) -> dict:
    """The quality gates of bench.py:183-187,228 on a time-major flagship
    cube ``[N_COLLECT, N_CHAINS, DIM]``; returns the gated numbers."""
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    x0 = sample[:, :, 0]
    m = {
        "rhat_mean": float(rhat.mean()),
        "ess_mean": float(ess.mean()),
        "ess_min": float(ess.min()),
        "x0_mean": float(x0.mean()),
        "x0_var": float(x0.var(unbiased=False)),
    }
    total_draws = N_CHAINS * N_COLLECT
    check("hmc rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    check("hmc ess floor", m["ess_min"] >= 0.01 * total_draws,
          (m["ess_min"], total_draws))
    check("hmc x0 mean", abs(m["x0_mean"] - ROSEN3D_X0_MEAN) <= 0.05,
          m["x0_mean"])
    check("hmc x0 var", abs(m["x0_var"] - ROSEN3D_X0_VAR) <= 0.04,
          m["x0_var"])
    # the contiguous [512, 2048, 3] tail bench.py:191-204 gates: chains are
    # exchangeable and the last draws are the steady state
    modern = mt.rank_normalized_diagnostics(gate_cube(sample),
                                            time_major=True)
    m["rank_rhat_max"] = float(modern.rhat.max())
    check("hmc rank-normalized rhat", m["rank_rhat_max"] <= 1.02,
          m["rank_rhat_max"])
    return m


def gate_cube(sample):
    """The flagship gate's sub-cube, the last 512 draws of 2,048 chains."""
    return sample[N_COLLECT - 512:, :2048]


def phase_main_path(dev):
    """The flagship through the public entry points. Returns the sampler,
    the launch counts of the main path (burn-in and timed run) and those
    of a separate one-block ``use_pallas=True`` run."""
    target = mt.rosenbrock_nd()
    init = mt.init_with_seed(N_CHAINS, DIM, seed=42, device=dev) * 0.5 + 1.0
    reset_counts()
    hmc = mt.HMC(target, init, STEP_SIZE, N_LEAPFROG, use_pallas="full",
                 jitter=JITTER, steps_per_call=STEPS_PER_CALL).seed(42)
    per_run = N_COLLECT // STEPS_PER_CALL
    burn = hmc.run(N_COLLECT, 0, time_major=True)
    torch.cuda.synchronize()
    check("burn-in launches", hmc_multistep.launches == per_run,
          hmc_multistep.launches)
    del burn

    t0 = time.perf_counter()
    sample = hmc.run(N_COLLECT, 0, time_major=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    check("main-path launches and no plain twin",
          counts == counts_with(hmc_multistep=2 * per_run), counts)
    check("sample shape", tuple(sample.shape) == (N_COLLECT, N_CHAINS, DIM),
          tuple(sample.shape))
    check("sample finite", bool(torch.isfinite(sample).all()), "non-finite")

    m = {"elapsed_s": elapsed, **hmc_gates(sample)}
    del sample
    steps_per_sec = N_COLLECT / elapsed
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = steps_per_sec * N_CHAINS
    m["grad_evals_per_sec"] = m["draws_per_sec"] * N_LEAPFROG

    # the trajectory-kernel tier through the same entry point, one block;
    # not part of the main path, so counted on its own
    reset_counts()
    tier = mt.HMC(target, hmc.positions, STEP_SIZE, N_LEAPFROG,
                  use_pallas=True, jitter=JITTER,
                  steps_per_call=STEPS_PER_CALL).seed(7)
    rows = tier.run(STEPS_PER_CALL, 0, time_major=True)
    torch.cuda.synchronize()
    check("use_pallas=True rows", bool(torch.isfinite(rows).all())
          and tuple(rows.shape) == (STEPS_PER_CALL, N_CHAINS, DIM),
          tuple(rows.shape))
    tier_counts = read_counts()
    check("use_pallas=True launches", tier_counts == counts_with(
        leapfrog_trajectory=STEPS_PER_CALL), tier_counts)
    say("main_path", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    say("tier_run", use_pallas=True, steps=STEPS_PER_CALL, **tier_counts)
    return hmc, counts, tier_counts


def phase_leapfrog(target, state, dev, step_size=STEP_SIZE,
                   label="leapfrog") -> dict:
    """Kernel 1 against its plain twin, and both against the twin run in
    float64, from ``state`` (the flagship's equilibrium, or its whitened
    chains: ``target`` is then the whitened target). Rosenbrock
    trajectories near the leapfrog stability edge (large |x0|, eps *
    sqrt(curvature) close to 2) amplify a one-ulp difference without
    bound, so the gate is that the kernel agrees with the float64
    trajectory on at least as many chains as the float32 twin does, less
    0.1% of the chains."""
    gen = torch.Generator(device=dev).manual_seed(11)
    mom = torch.randn(state.positions.shape, generator=gen, device=dev)
    eps = torch.tensor([step_size], device=dev)
    out = {}
    for n_leapfrog in (8, N_LEAPFROG):
        k = leapfrog_trajectory(target, state.positions, mom, state.grad,
                                eps, n_leapfrog)
        p = leapfrog_trajectory_plain(target, state.positions, mom,
                                      state.grad, eps[0], n_leapfrog)
        p64 = leapfrog_trajectory_plain(
            target, state.positions.double(), mom.double(),
            state.grad.double(), eps[0].double(), n_leapfrog)

        def share(xs, ys):
            agree = torch.stack([chain_agree(a, b.to(a.dtype))
                                 for a, b in zip(xs, ys)]).all(0)
            return float(agree.float().mean())

        err = max(max_abs_err(a, b) for a, b in zip(k, p))
        out[n_leapfrog] = (err, share(k, p), share(k, p64), share(p, p64))
        say(label, L=n_leapfrog, chains=state.positions.shape[0],
            max_abs_err=err, share_kernel_vs_plain=out[n_leapfrog][1],
            share_kernel_vs_f64=out[n_leapfrog][2],
            share_plain_vs_f64=out[n_leapfrog][3])
    _, _, k64, p64 = out[8]
    check(f"{label} L=8 accuracy", k64 >= p64 - 1e-3, out[8])
    return out


def phase_multistep(target, s, dev, step_size=STEP_SIZE,
                    label="multistep", n_leapfrog=8, chain0=0) -> float:
    """Kernel 2 against its plain twin for one K = 16, L = ``n_leapfrog``
    block from ``s`` (as :func:`phase_leapfrog`), same key and first
    global chain ``chain0``: the accepts, the rows and the returned state
    per chain."""
    k_steps, seed = STEPS_PER_CALL, 0x5EED_1234_ABCD
    gen = torch.Generator(device=dev).manual_seed(13)
    eps = step_size * (1.0 + JITTER * (
        2.0 * torch.rand((k_steps,), generator=gen, device=dev) - 1.0))
    hk = torch.empty((k_steps,) + tuple(s.positions.shape), device=dev)
    hp = torch.empty_like(hk)
    outk = hmc_multistep(target, s.positions, s.logp, s.grad, eps,
                         n_leapfrog, seed, 0, hk, chain0=chain0)
    outp = hmc_multistep_plain(target, s.positions, s.logp, s.grad, eps,
                               n_leapfrog, seed, 0, hp, chain0=chain0)
    torch.cuda.synchronize()

    def accepts(h):
        prev = torch.cat([s.positions[None], h[:-1]], dim=0)
        return (h != prev).any(dim=2)  # [K, C]

    acc_k, acc_p = accepts(hk), accepts(hp)
    same_acc = (acc_k == acc_p).all(dim=0)
    pos_ok = chain_agree(hk.transpose(0, 1), hp.transpose(0, 1))
    pos_ok &= chain_agree(outk[0], outp[0])
    # the returned state feeds the next block's h_cur and first half-kick
    logp_ok = chain_agree(outk[1][:, None], outp[1][:, None])
    grad_ok = grad_agree(outk[2], outp[2])
    # and is the density at the returned position: the plain target there
    self_ok = chain_agree(outk[1][:, None],
                          target.batch_logp(outk[0])[:, None])
    self_ok &= grad_agree(outk[2], target.batch_grad(outk[0]))
    shares = {name: float((same_acc & ok).float().mean()) for name, ok in
              (("positions", pos_ok), ("logp", logp_ok), ("grad", grad_ok))}
    share_acc = float(same_acc.float().mean())
    share_self = float(self_ok.float().mean())
    err = max_abs_err(hk.transpose(0, 1), hp.transpose(0, 1), same_acc)
    say(label, K=k_steps, L=n_leapfrog, chains=s.positions.shape[0],
        chain0=chain0, accept_rate=float(acc_k.float().mean()),
        share_same_accepts=share_acc,
        **{f"share_{k}_within_tol": v for k, v in shares.items()},
        share_state_is_density_at_pos=share_self,
        max_abs_err_same_accepts=err,
        max_abs_err_logp_same_accepts=max_abs_err(outk[1], outp[1],
                                                  same_acc))
    check(f"{label} accepts agree", share_acc >= 0.999, share_acc)
    for name, share in shares.items():
        check(f"{label} {name}", share >= 0.999, share)
    check(f"{label} state is the density at its position",
          share_self == 1.0, share_self)
    return err


def phase_times(hmc, dev) -> dict:
    target = hmc.target
    s = hmc.state
    gen = torch.Generator(device=dev).manual_seed(17)
    mom = torch.randn(s.positions.shape, generator=gen, device=dev)
    eps1 = torch.tensor([STEP_SIZE], device=dev)
    eps = torch.full((STEPS_PER_CALL,), STEP_SIZE, device=dev)
    hist = torch.empty((STEPS_PER_CALL, N_CHAINS, DIM), device=dev)
    t = {
        "leapfrog_ms": cuda_ms(lambda: leapfrog_trajectory(
            target, s.positions, mom, s.grad, eps1, N_LEAPFROG), 20),
        "leapfrog_plain_ms": cuda_ms(lambda: leapfrog_trajectory_plain(
            target, s.positions, mom, s.grad, eps1[0], N_LEAPFROG), 3),
        "multistep_ms": cuda_ms(lambda: hmc_multistep(
            target, s.positions, s.logp, s.grad, eps, N_LEAPFROG, 1, 0,
            hist), 20),
        "multistep_plain_ms": cuda_ms(lambda: hmc_multistep_plain(
            target, s.positions, s.logp, s.grad, eps, N_LEAPFROG, 1, 0,
            hist), 2),
        "philox_ms": cuda_ms(lambda: rng.philox_fill(
            N_CHAINS * (DIM + 1), 0, 0, 1, dev), 20),
        "philox_plain_ms": cuda_ms(lambda: rng.philox_fill_plain(
            N_CHAINS * (DIM + 1), 0, 0, 1, dev), 5),
    }
    say("times", shape=f"C={N_CHAINS},D={DIM},L={N_LEAPFROG},"
        f"K={STEPS_PER_CALL}", **{k: repr(v) for k, v in t.items()})
    return t


def phase_whitened_hmc(hmc, dev) -> dict:
    """Kernels 1 and 2's whitened instances (``metric=``): a diagonal
    metric estimated from the flagship's equilibrium, ``HMC(metric=)``
    on WHITENED_CHAINS of its chains through the ``True`` and ``"full"``
    tiers (one K-step block each, its launches counted, its rows in x),
    each kernel against its twin from that whitened state, and both
    kernels' times on all the flagship's chains whitened (CUDA events)."""
    pre = mt.estimate_preconditioner(hmc.positions, "diag")
    # a step in y of eps_x / max(scale) moves no coordinate of x by more
    # than the flagship's eps_x; reconditioned's eps_x / sigma_min would
    # move the widest by max/min scale times eps_x (2.7x at the flagship's
    # equilibrium), past the leapfrog's stability edge on some chains,
    # where kernel and twin both diverge
    eps = STEP_SIZE / float(pre.scale.max())
    x = hmc.positions[:WHITENED_CHAINS]
    runs = {}
    for tier, kernel, launches in ((True, "leapfrog_trajectory",
                                    STEPS_PER_CALL),
                                   ("full", "hmc_multistep", 1)):
        reset_counts()
        h = mt.HMC(hmc.target, x, eps, N_LEAPFROG, use_pallas=tier,
                   jitter=JITTER, steps_per_call=STEPS_PER_CALL,
                   metric=pre).seed(5)
        rows = h.run(STEPS_PER_CALL, 0, time_major=True)
        torch.cuda.synchronize()
        counts = read_counts()
        check(f"whitened {kernel} launches",
              counts == counts_with(**{kernel: launches}), counts)
        check(f"whitened {kernel} rows in x", bool(
            torch.isfinite(rows).all()) and torch.equal(rows[-1],
                                                        h.positions),
              tuple(rows.shape))
        runs[kernel] = counts[kernel]
    target, state = h.kernel_target, h.state
    lf = phase_leapfrog(target, state, dev, eps, label="leapfrog_whitened")
    ms_err = phase_multistep(target, state, dev, eps,
                             label="multistep_whitened")
    # the times at the flagship's shapes: all its chains, whitened
    y = pre.to_y(hmc.state.positions).contiguous()
    logp, grad = target.batch_logp_and_grad(y)
    gen = torch.Generator(device=dev).manual_seed(17)
    mom = torch.randn(y.shape, generator=gen, device=dev)
    eps1 = torch.tensor([eps], device=dev)
    eps_k = torch.full((STEPS_PER_CALL,), eps, device=dev)
    hist = torch.empty((STEPS_PER_CALL,) + tuple(y.shape), device=dev)
    out = {
        "leapfrog_err": lf[8][0], "multistep_err": ms_err,
        "leapfrog_launches": runs["leapfrog_trajectory"],
        "multistep_launches": runs["hmc_multistep"],
        "leapfrog_ms": cuda_ms(lambda: leapfrog_trajectory(
            target, y, mom, grad, eps1, N_LEAPFROG), 20),
        "multistep_ms": cuda_ms(lambda: hmc_multistep(
            target, y, logp, grad, eps_k, N_LEAPFROG, 1, 0, hist), 20),
    }
    say("whitened_hmc", metric="diag", scale=repr(pre.scale.tolist()),
        eps_y=eps, chains_checked=WHITENED_CHAINS,
        **{k: repr(v) for k, v in out.items()})
    return out


def phase_profile(hmc, dev) -> None:
    """``--profile``: the spread of five more timed runs of the main path,
    one more under ``torch.profiler``, and Kernel 1 at its shapes."""
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        hmc.run(N_COLLECT, 0, time_major=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    say("profile_runs", timed_s=repr(walls),
        spread=(max(walls) - min(walls)) / min(walls))
    wall, busy, by_name = device_profile(hmc.run, N_COLLECT, 0,
                                         time_major=True)
    say("profile_run", wall_s=repr(wall), device_busy_us=repr(busy),
        idle_share=1.0 - busy / (wall * 1e6), kernel_names=len(by_name))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        say("profile_kernel", name=repr(name[:60]), count=n, device_us=us,
            per_launch_us=us / n, share_of_busy=us / busy)

    s = hmc.state
    gen = torch.Generator(device=dev).manual_seed(19)
    mom = torch.randn(s.positions.shape, generator=gen, device=dev)
    eps = torch.tensor([STEP_SIZE], device=dev)
    reps = 20
    _, _, lf = device_profile(lambda: [leapfrog_trajectory(
        hmc.target, s.positions, mom, s.grad, eps, N_LEAPFROG)
        for _ in range(reps)])
    # the profiler may miss the first launches of a burst: the time per
    # call is over the launches it recorded
    n, us = next(v for k, v in lf.items() if "leapfrog_kernel" in k)
    check("profiled leapfrog launches", 0 < n <= reps, n)
    say("profile_leapfrog", L=N_LEAPFROG, calls=reps, recorded=n,
        device_us_per_call=us / n)


def nuts_gates(sample, divergences_steady: int | None, ess_floor=0.005,
               label="nuts", want_mean=NUTS_MEAN,
               want_var=(NUTS_COV[0][0], NUTS_COV[1][1]),
               divergence_limit: int | None = None) -> dict:
    """The quality gates of bench.py:321-336 on a chain-major cube, or with
    ``ess_floor=0.01`` and no divergence gate (``divergences_steady``
    None) those of its dense-metric stage, bench.py:370-379; the moments
    held to ``want_mean`` and ``want_var`` (the Gaussian's by default),
    the steady-state divergences to ``divergence_limit`` (bench.py's C /
    10,000 by default)."""
    rhat, ess = mt.split_rhat_mean_ess(sample)
    flat = sample.reshape(-1, 2).double()
    m = {
        "rhat_mean": float(rhat.mean()),
        "ess_mean": float(ess.mean()),
        "ess_min": float(ess.min()),
        "mean": [float(x) for x in flat.mean(dim=0)],
        "var": [float(x) for x in flat.var(dim=0, unbiased=False)],
        "divergences_steady": divergences_steady,
    }
    total_draws = sample.shape[0] * sample.shape[1]
    check(f"{label} rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    check(f"{label} ess floor", m["ess_min"] >= ess_floor * total_draws,
          (m["ess_min"], total_draws))
    for d in range(2):
        check(f"{label} mean[{d}]",
              abs(m["mean"][d] - want_mean[d]) <= 0.08, m["mean"])
        check(f"{label} var[{d}]",
              abs(m["var"][d] - want_var[d]) <= 0.4, m["var"])
    if divergences_steady is not None:
        limit = (sample.shape[0] // 10000 if divergence_limit is None
                 else divergence_limit)
        check(f"{label} steady-state divergences",
              divergences_steady <= limit, (divergences_steady, limit))
    return m


def phase_nuts_main_path(dev):
    """The NUTS stage of bench.py:286-336 through the public entry point:
    an adaptation run, then the timed run, the gates, and the launch
    counts of both runs; then a short use_pallas=True run counted on its
    own."""
    target = mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV)
    init = mt.init_with_seed(NUTS_CHAINS, 2, seed=7, device=dev)
    reset_counts()
    nuts = mt.NUTS(target, init, 0.8, use_pallas="full").seed(7)
    adapt = nuts.run(NUTS_COLLECT, NUTS_DISCARD)
    torch.cuda.synchronize()
    del adapt
    divergences_first_run = int(nuts.divergences.sum())

    t0 = time.perf_counter()
    sample = nuts.run(NUTS_COLLECT, NUTS_DISCARD)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    check("nuts main-path launches and no plain twin",
          counts == counts_with(nuts_step=2 * NUTS_STEPS), counts)
    check("nuts sample shape",
          tuple(sample.shape) == (NUTS_CHAINS, NUTS_COLLECT, 2),
          tuple(sample.shape))
    check("nuts sample finite", bool(torch.isfinite(sample).all()),
          "non-finite")
    m = nuts_gates(sample, int(nuts.last_run_divergences.sum()))
    del sample
    m["elapsed_s"] = elapsed
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = NUTS_STEPS * NUTS_CHAINS / elapsed
    m["step_us"] = elapsed / NUTS_STEPS * 1e6
    m["leapfrogs_per_draw"] = float(
        nuts.last_run_leapfrogs.double().mean()) / NUTS_STEPS
    m["divergences_first_run"] = divergences_first_run
    m["step_size_mean"] = float(nuts.step_size.mean())
    say("nuts_main_path", **{k: repr(v) for k, v in m.items()},
        launches_per_run=NUTS_STEPS, **counts)

    # the subtree tier through the same entry point, a short run; not
    # part of the main path, so counted on its own
    reset_counts()
    tier = mt.NUTS(target, nuts.positions, 0.8, use_pallas=True).seed(3)
    rows = tier.run(16, 0)
    torch.cuda.synchronize()
    tier_counts = read_counts()
    check("nuts use_pallas=True rows", bool(torch.isfinite(rows).all())
          and tuple(rows.shape) == (NUTS_CHAINS, 16, 2), tuple(rows.shape))
    check("nuts use_pallas=True launches",
          tier_counts["nuts_subtree"] > 0 and tier_counts == counts_with(
              nuts_subtree=tier_counts["nuts_subtree"]), tier_counts)
    say("nuts_tier_run", use_pallas=True, steps=15, **tier_counts)
    return nuts, m, counts, tier_counts


def phase_nuts_dense_metric(nuts, dev):
    """The dense-metric half of the NUTS stage, bench.py:355-387, through
    the public entry point: ``reconditioned("dense", seed=11)`` from the
    stage's equilibrium (a new sampler, which finds its step size and
    adapts again in the whitened space), an adaptation run, the timed run,
    bench.py:370-379's gates and the launch counts of both runs (Kernel
    4's whitened instance, once a step); then a short ``use_pallas=True``
    run with the metric, counted on its own (Kernel 3's)."""
    reset_counts()
    tuned = nuts.reconditioned("dense", seed=11)
    check("dense metric on the card", tuned.metric.chol.is_cuda
          and tuned.kernel_target.cuda_affine, tuned.metric)
    adapt = tuned.run(NUTS_COLLECT, NUTS_DISCARD)
    torch.cuda.synchronize()
    del adapt
    t0 = time.perf_counter()
    sample = tuned.run(NUTS_COLLECT, NUTS_DISCARD)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    check("nuts-metric launches and no plain twin",
          counts == counts_with(nuts_step=2 * NUTS_STEPS), counts)
    check("nuts-metric sample shape",
          tuple(sample.shape) == (NUTS_CHAINS, NUTS_COLLECT, 2),
          tuple(sample.shape))
    check("nuts-metric sample finite", bool(torch.isfinite(sample).all()),
          "non-finite")
    m = nuts_gates(sample, None, ess_floor=0.01, label="nuts-metric")
    del sample
    m["elapsed_s"] = elapsed
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = NUTS_STEPS * NUTS_CHAINS / elapsed
    m["step_us"] = elapsed / NUTS_STEPS * 1e6
    m["leapfrogs_per_draw"] = float(
        tuned.last_run_leapfrogs.double().mean()) / NUTS_STEPS
    m["divergences_run"] = int(tuned.last_run_divergences.sum())
    m["step_size_mean"] = float(tuned.step_size.mean())
    m["chol"] = tuned.metric.chol.tolist()
    say("nuts_dense_metric", **{k: repr(v) for k, v in m.items()},
        launches_per_run=NUTS_STEPS, **counts)

    reset_counts()
    tier = mt.NUTS(nuts.target, tuned.positions, 0.8, use_pallas=True,
                   metric=tuned.metric).seed(3)
    rows = tier.run(16, 0)
    torch.cuda.synchronize()
    tier_counts = read_counts()
    check("nuts-metric use_pallas=True rows", bool(
        torch.isfinite(rows).all()) and tuple(rows.shape) == (
            NUTS_CHAINS, 16, 2), tuple(rows.shape))
    check("nuts-metric use_pallas=True launches",
          tier_counts["nuts_subtree"] > 0 and tier_counts == counts_with(
              nuts_subtree=tier_counts["nuts_subtree"]), tier_counts)
    say("nuts_dense_metric_tier_run", use_pallas=True, steps=15,
        **tier_counts)
    return tuned, m, counts, tier_counts


def subtree_inputs(nuts, dev, j: int, seed: int, eps_scale: float = 1.0):
    """A Kernel 3 call at the NUTS equilibrium: fresh momenta, slice
    levels and directions, nine chains in ten active, the adapted steps
    times ``eps_scale``; in the whitened coordinates under a metric."""
    target, pos = nuts.kernel_target, nuts.state.positions
    gen = torch.Generator(device=dev).manual_seed(seed)
    mom = torch.randn(pos.shape, generator=gen, device=dev)
    logp, grad = target.batch_logp_and_grad(pos)
    joint0 = logp - 0.5 * (mom * mom).sum(dim=1)
    logu = joint0 - torch.empty_like(joint0).exponential_(generator=gen)
    u = torch.rand((2, pos.shape[0]), generator=gen, device=dev)
    v = torch.where(u[0] < 0.5, -1, 1).to(torch.int32)
    active = u[1] < 0.9
    return (target, pos, mom, grad, logu, v, j,
            (nuts.step_size * eps_scale).contiguous(), joint0, active,
            (0x1234567, -0x7654321), NUTS_MAX_DEPTH)


def subtree_case(nuts, dev, j: int, cut: int = 0, seed: int | None = None,
                 label: str = "subtree", chain0: int = 0):
    """Kernel 3 against its twin at ``j`` with the steps times 2^-cut and
    the hash's lanes from global chain ``chain0``: counts and flags on
    every chain, active and inactive apart, floats where the subtree
    continues (a stopped chain's end state and proposal are not read).
    Returns the largest error, the twin's leaves per chain and the
    lane-iterations per leaf."""
    seed = 40 + j + 20 * (cut > 0) if seed is None else seed
    args = subtree_inputs(nuts, dev, j, seed=seed, eps_scale=2.0 ** -cut)
    grid = {}
    got = subtree(*args, grid=grid, chain0=chain0)
    n_chains = args[1].shape[0]
    done = torch.zeros(n_chains, dtype=torch.int32, device=dev)
    want = subtree_plain(*args, leaves=done, chain0=chain0)
    torch.cuda.synchronize()
    active = args[9]
    same = ((got.n == want.n) & (got.s == want.s)
            & (got.n_alpha == want.n_alpha)
            & (got.diverged == want.diverged))

    def near(a, b):
        ok = (a - b).abs() <= NUTS_ATOL + NUTS_RTOL * b.abs()
        return ok.reshape(ok.shape[0], -1).all(dim=1)

    ok = same & near(got.alpha, want.alpha)
    s = same & want.s
    for a, b in zip(got[:6], want[:6]):
        ok &= near(a, b) | ~s
    # the chains whose subtree ran all 2^j leaves and continues
    full = (done == 1 << j) & want.s
    shares = {
        "same_counts_and_flags_active": float(
            same[active].double().mean()),
        "same_counts_and_flags_inactive": float(
            same[~active].double().mean()),
        "all_fields_within_tol": float(ok.double().mean()),
    }
    if cut:
        shares["all_fields_within_tol_all_leaves"] = float(
            ok[full].double().mean())
    # a warp of 32 fixed chains runs its deepest chain's leaves: its
    # lane-iterations over the leaves its chains integrate
    lane_iterations = 32 * float(
        done.reshape(-1, 32).amax(dim=1).double().sum())
    per_leaf = lane_iterations / float(done.double().sum())
    e = max(max_abs_err(a, b, s) for a, b in zip(got[:6], want[:6]))
    e = max(e, max_abs_err(got.alpha, want.alpha, same))
    share_full = float(full.double().mean())
    say(label, j=j, eps_scale=f"2^-{cut}", chains=n_chains, chain0=chain0,
        **{f"share_{k}": v for k, v in shares.items()},
        share_s=float(want.s.double().mean()),
        share_all_leaves=share_full,
        mean_leaves=float(done.double().mean()),
        max_leaves=int(done.max()),
        lane_iterations_per_leaf=per_leaf, **grid, max_abs_err=e)
    for name, share in shares.items():
        check(f"{label} j={j} cut={cut} {name}", share >= NUTS_SHARE, share)
    if cut:  # the deepest rows and merges ran on most chains
        check(f"{label} j={j} cut={cut} all leaves", share_full >= 0.5,
              share_full)
    return e, done, per_leaf


def phase_subtree(nuts, dev) -> tuple[float, dict, dict]:
    """Kernel 3 against its twin on the NUTS equilibrium state, j = 0..5
    and 10 (the deepest stack, past 48 KB of shared memory a block), and
    at j = 5 and 10 with the steps cut by 2^-j, where most chains run all
    2^j leaves: every row of the stack and every merge of the cascade.
    Returns the largest error, the twin's leaves per chain and the
    lane-iterations per leaf, by j, at the equilibrium's steps."""
    err, leaves, per_leaf = 0.0, {}, {}
    # (j, cut): the steps times 2^-cut
    cases = [(j, 0) for j in (*range(6), NUTS_MAX_DEPTH)]
    for j, cut in cases + [(5, 5), (NUTS_MAX_DEPTH, NUTS_MAX_DEPTH)]:
        e, done, lanes = subtree_case(nuts, dev, j, cut)
        if not cut:
            leaves[j], per_leaf[j] = done, lanes
        err = max(err, e)
    return err, leaves, per_leaf


def phase_k3_alone(nuts, dev, reps: int = 20) -> dict:
    """``--profile``: Kernel 3 alone at j = 0..5 on the inputs of
    phase_subtree, device µs per launch (``torch.profiler`` over ``reps``
    back-to-back launches, over the launches it recorded), twice. Returns
    the mean µs by j."""
    out = {}
    for j in range(6):
        args = subtree_inputs(nuts, dev, j, seed=40 + j)
        subtree(*args)
        times = []
        for _ in range(2):
            _, _, k = device_profile(lambda: [subtree(*args)
                                              for _ in range(reps)],
                                              expect="subtree_kernel")
            n, us = next(v for name, v in k.items()
                         if "subtree_kernel" in name)
            check(f"profiled subtree j={j} launches", 0 < n <= reps, n)
            times.append(us / n)
        say("k3_alone", j=j, calls=reps, device_us_per_call=repr(times))
        out[j] = sum(times) / len(times)
    return out


def warp_max(v: torch.Tensor) -> torch.Tensor:
    """Each element's largest value over its warp of 32 consecutive
    elements (the last warp may hold fewer)."""
    warp = torch.arange(v.numel(), device=v.device) // 32
    top = torch.full((int(warp[-1]) + 1,), torch.iinfo(v.dtype).min,
                     dtype=v.dtype, device=v.device)
    return top.scatter_reduce(0, warp, v, "amax")[warp]


def phase_nuts_step(nuts, dev, label="nuts_step", chain0=0):
    """Kernel 4 against its twin for one step from the NUTS equilibrium,
    same key and step, depth_limit 10, draws from global chain ``chain0``
    on: positions, alpha, n_alpha, divergences and each chain's own depth
    per chain, the launch's leaves against the twin's, its persistent grid
    and its results bit for bit under other grids. The state is the
    sampler's own (whitened under a metric). Returns the largest error,
    the twin's details and the arguments."""
    args = (nuts.kernel_target, nuts.state.positions,
            nuts.step_size.contiguous(), NUTS_MAX_DEPTH,
            0x5EED_0123_4567_89AB, 9, NUTS_MAX_DEPTH) + (
                (chain0,) if chain0 else ())
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    grid = {}
    got = nuts_step(*args, stats=stats, grid=grid)
    details = {}
    want = nuts_step_plain(*args, details=details)
    torch.cuda.synchronize()
    same_pos = chain_agree(got[0], want[0])
    near = [((a - b).abs() <= NUTS_ATOL + NUTS_RTOL * b.abs())
            for a, b in zip(got[1:4], want[1:4])]
    shares = {
        "position": float(same_pos.float().mean()),
        "alpha": float(near[0].float().mean()),
        "n_alpha": float(near[1].float().mean()),
        "diverged": float(near[2].float().mean()),
        "depth": float((got[4] == want[4]).float().mean()),
    }
    err = max_abs_err(got[0], want[0], same_pos)
    depth = {
        "chain_depth_mean": float(details["depth"].double().mean()),
        "chain_depth_max": int(details["depth"].max()),
        # chains by doubling count: the deepest chain's 2^depth - 1 leaves
        # run in sequence on one lane, a floor under the launch's time
        "chain_depth_counts": torch.bincount(details["depth"]).tolist(),
        "leaves_per_chain": float(details["leaves"].double().mean()),
        # what a warp of 32 fixed chains would integrate: 2^(its deepest
        # depth) - 1 leaves for each of them (the one-thread-per-chain form;
        # the last warp holds what is left of the chains)
        "fixed_warp_leaves_per_chain": float(
            (2.0 ** warp_max(details["depth"]).double() - 1).mean()),
    }
    n_chains = args[1].shape[0]
    say(label, chains=n_chains, depth_limit=NUTS_MAX_DEPTH,
        **{f"share_{k}": v for k, v in shares.items()}, **depth,
        max_abs_err=err)
    for name, share in shares.items():
        check(f"{label} {name}", share >= NUTS_SHARE, share)

    # the load balance: every lane-iteration of the launch over the leaves
    # its threads integrated (1 is no lane idle), the persistent grid, and
    # the results under other grids
    lane_iterations, leaves = (int(v) for v in stats.cpu())
    say(f"{label}_balance", lane_iterations=lane_iterations, leaves=leaves,
        twin_leaves=int(details["leaves"].sum()),
        lane_iterations_per_leaf=lane_iterations / leaves, **grid)
    check(f"{label} kernel leaves", abs(
        leaves - int(details["leaves"].sum())) <= 0.001 * leaves,
        (leaves, int(details["leaves"].sum())))
    check(f"{label} persistent grid", grid["blocks"] == min(
        grid["blocks_per_sm"] * grid["sms"],
        -(-n_chains // grid["threads"])), grid)
    details["grid"] = grid
    for kw in (dict(blocks=1), dict(blocks=grid["sms"])):
        other = nuts_step(*args, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, other))
        check(f"{label} bit-identical under {kw}", same, kw)
    return err, details, args


def phase_whitened_nuts(tuned, dev, profile: bool = False) -> dict:
    """Kernels 4 and 3's whitened instances (the dense metric of the
    stage, Gaussian2D at D = 2) against their twins at the dense stage's
    equilibrium, Kernel 3 at j = 4, and their times (CUDA events); with
    ``profile``, Kernel 4's whitened instance alone (device µs a launch,
    ``torch.profiler`` over 20 launches, twice)."""
    err, details, args = phase_nuts_step(tuned, dev,
                                         label="nuts_step_dense_metric")
    sub_err, _, sub_per_leaf = subtree_case(tuned, dev, 4,
                                            label="subtree_dense_metric")
    sub_args = subtree_inputs(tuned, dev, 4, seed=44)
    out = {
        "ms": cuda_ms(lambda: nuts_step(*args), 20),
        "plain_ms": cuda_ms(lambda: nuts_step_plain(*args), 2),
        "subtree_ms": cuda_ms(lambda: subtree(*sub_args), 20),
    }
    if profile:
        times = []
        for _ in range(2):
            _, _, k = device_profile(lambda: [nuts_step(*args)
                                              for _ in range(20)],
                                              expect="nuts_step_kernel")
            n, us = next(v for name, v in k.items()
                         if "nuts_step_kernel" in name)
            check("profiled whitened nuts_step launches", 0 < n <= 20, n)
            times.append(us / n)
        out["device_us_alone"] = times
    say("nuts_dense_metric_times", shape=f"C={NUTS_CHAINS},D=2,"
        f"depth_limit={NUTS_MAX_DEPTH},subtree_j=4",
        **{k: repr(v) for k, v in out.items()})
    return dict(out, err=err, details=details, subtree_err=sub_err,
                subtree_lane_iterations_per_leaf=sub_per_leaf)


def phase_nuts_times(nuts, dev, step_args) -> dict:
    sub_args = subtree_inputs(nuts, dev, 4, seed=44)
    t = {
        "nuts_step_ms": cuda_ms(lambda: nuts_step(*step_args), 20),
        "nuts_step_plain_ms": cuda_ms(lambda: nuts_step_plain(*step_args), 2),
        "subtree_ms": cuda_ms(lambda: subtree(*sub_args), 20),
        "subtree_plain_ms": cuda_ms(lambda: subtree_plain(*sub_args), 2),
    }
    say("nuts_times", shape=f"C={NUTS_CHAINS},D=2,depth_limit="
        f"{NUTS_MAX_DEPTH},subtree_j=4", **{k: repr(v) for k, v in t.items()})
    return t


def phase_nuts_profile(nuts, step_args) -> None:
    """``--profile``: one timed NUTS run under ``torch.profiler``, Kernel 4
    alone at the shapes of its timing and under smaller grids (Kernel 3
    alone is phase_k3_alone's), and a ``use_pallas=True`` run under
    ``torch.profiler``."""
    wall, busy, by_name = device_profile(nuts.run, NUTS_COLLECT, NUTS_DISCARD)
    say("nuts_profile_run", wall_s=repr(wall), device_busy_us=repr(busy),
        idle_share=1.0 - busy / (wall * 1e6), kernel_names=len(by_name))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        say("nuts_profile_kernel", name=repr(name[:60]), count=n,
            device_us=us, per_launch_us=us / n, share_of_busy=us / busy)
    reps = 20
    _, _, k = device_profile(lambda: [nuts_step(*step_args)
                                      for _ in range(reps)],
                             expect="nuts_step_kernel")
    n, us = next(v for name, v in k.items() if "nuts_step_kernel" in name)
    check("profiled nuts_step launches", 0 < n <= reps, n)
    say("nuts_profile_kernel_alone", kernel="nuts_step", calls=reps,
        recorded=n, device_us_per_call=us / n)
    # Kernel 4 under smaller grids than the resident one: device time
    grid = {}
    nuts_step(*step_args, grid=grid)
    for blocks in (grid["blocks"] // 2, grid["blocks"] // 4,
                   grid["blocks"] // 8):
        _, _, k = device_profile(lambda: [nuts_step(
            *step_args, blocks=blocks) for _ in range(reps)],
            expect="nuts_step_kernel")
        n, us = next(v for name, v in k.items() if "nuts_step_kernel" in name)
        say("nuts_profile_grid", blocks=blocks,
            chains_per_thread=NUTS_CHAINS / (blocks * 128), calls=reps,
            recorded=n, device_us_per_call=us / n)
    # the subtree tier's run of phase_nuts_main_path, once warm: Kernel 3's
    # share of its device time and the idle share
    tier = mt.NUTS(nuts.target, nuts.positions, 0.8, use_pallas=True).seed(3)
    tier.run(16, 0)
    wall, busy, by_name = device_profile(tier.run, 16, 0,
                                         expect="subtree_kernel")
    n, us = next(v for name, v in by_name.items() if "subtree_kernel" in name)
    say("nuts_tier_profile_run", steps=15, wall_s=repr(wall),
        device_busy_us=repr(busy), idle_share=1.0 - busy / (wall * 1e6),
        subtree_launches=n, subtree_us_per_launch=us / n,
        subtree_share_of_busy=us / busy, kernel_names=len(by_name))


def timed_run(sampler, *run_args, time_major=False):
    """A warm-up run, then the timed run; returns (sample, seconds)."""
    warm = sampler.run(*run_args, time_major=time_major)
    torch.cuda.synchronize()
    del warm
    t0 = time.perf_counter()
    sample = sampler.run(*run_args, time_major=time_major)
    torch.cuda.synchronize()
    return sample, time.perf_counter() - t0


def phase_mh_main_path(dev):
    """The MH stage of bench.py:391-431 through the public entry point:
    warm-up and timed run, the gates of bench.py:416-421, and the launch
    counts of both runs."""
    target = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    init = mt.init_with_seed(MH_CHAINS, 2, seed=8, device=dev)
    reset_counts()
    mh = mt.MetropolisHastings(target, mt.isotropic_gaussian_proposal(1.0),
                               init, use_pallas="full",
                               steps_per_call=MH_K).seed(8)
    sample, elapsed = timed_run(mh, MH_COLLECT, 0, time_major=True)
    counts = read_counts()
    per_run = MH_COLLECT // MH_K
    check("mh main-path launches and no plain twin",
          counts == counts_with(mh_multistep=2 * per_run), counts)
    check("mh sample shape",
          tuple(sample.shape) == (MH_COLLECT, MH_CHAINS, 2),
          tuple(sample.shape))
    check("mh sample finite", bool(torch.isfinite(sample).all()), "non-finite")
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    mean = sample.mean(dim=(0, 1))
    var = sample.var(dim=(0, 1), unbiased=False)
    moved = (sample[1:] != sample[:-1]).any(dim=2)
    total = MH_CHAINS * MH_COLLECT
    m = {
        "elapsed_s": elapsed,
        "rhat_mean": float(rhat.mean()),
        "ess_mean": float(ess.mean()),
        "mean": [float(v) for v in mean],
        "var": [float(v) for v in var],
        "accept_rate": float(moved.float().mean()),
    }
    del sample, moved
    check("mh rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    for d in range(2):
        check(f"mh mean[{d}]", abs(m["mean"][d]) <= 0.03, m["mean"])
        check(f"mh var[{d}]", abs(m["var"][d] - 1.0) <= 0.05, m["var"])
    check("mh ess floor", m["ess_mean"] >= 0.02 * total,
          (m["ess_mean"], total))
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = total / elapsed
    m["block_us"] = elapsed / per_run * 1e6
    say("mh_main_path", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    return mh, counts


def phase_poisson_main_path(dev):
    """The Poisson stage of bench.py:495-525: int32 states through the
    public entry point, the pmf gate and the launch counts."""
    init = torch.zeros((MH_CHAINS, 1), dtype=torch.int32, device=dev)
    reset_counts()
    mh = mt.MetropolisHastings(mt.poisson_target(POISSON_LAM),
                               mt.random_walk_int_proposal(), init,
                               use_pallas="full",
                               steps_per_call=POISSON_K).seed(42)
    sample, elapsed = timed_run(mh, POISSON_COLLECT, POISSON_DISCARD)
    counts = read_counts()
    per_run = (POISSON_COLLECT + POISSON_DISCARD) // POISSON_K
    check("poisson main-path launches and no plain twin",
          counts == counts_with(mh_multistep=2 * per_run), counts)
    check("poisson int32 states", sample.dtype == torch.int32
          and mh.state.positions.dtype == torch.int32
          and mh.state.logp.dtype == torch.float32, sample.dtype)
    check("poisson sample shape",
          tuple(sample.shape) == (MH_CHAINS, POISSON_COLLECT, 1),
          tuple(sample.shape))
    ks = sample.reshape(-1).long()
    check("poisson support", int(ks.min()) >= 0, int(ks.min()))
    freq = torch.bincount(ks, minlength=11)[:11].double() / ks.numel()
    k = torch.arange(11, dtype=torch.float64, device=dev)
    pmf = torch.exp(k * math.log(POISSON_LAM) - POISSON_LAM
                    - torch.lgamma(k + 1.0))
    steps = POISSON_COLLECT + POISSON_DISCARD
    m = {
        "elapsed_s": elapsed,
        "pmf_max_abs_err": float((freq - pmf).abs().max()),
        "draws_per_sec": MH_CHAINS * steps / elapsed,
        "block_us": elapsed / per_run * 1e6,
    }
    check("poisson pmf", m["pmf_max_abs_err"] < 0.05, m["pmf_max_abs_err"])
    say("poisson_main_path", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    return mh, counts


def phase_gibbs_main_path(dev):
    """The Gibbs stage of bench.py:434-478 through the public entry point:
    warm-up and timed run, the gates of bench.py:464-467 and the launch
    counts."""
    mu0, sigma0, mu1, sigma1, pi0 = MIX
    init = torch.zeros((MH_CHAINS, 2), device=dev)
    reset_counts()
    g = mt.GibbsSampler(mt.gaussian_mixture_conditional(*MIX), init,
                        use_pallas="full", steps_per_call=GIBBS_K).seed(42)
    sample, elapsed = timed_run(g, GIBBS_COLLECT, 0, time_major=True)
    counts = read_counts()
    per_run = GIBBS_COLLECT // GIBBS_K
    check("gibbs main-path launches and no plain twin",
          counts == counts_with(gibbs_multistep=2 * per_run), counts)
    check("gibbs sample shape",
          tuple(sample.shape) == (GIBBS_COLLECT, MH_CHAINS, 2),
          tuple(sample.shape))
    check("gibbs sample finite", bool(torch.isfinite(sample).all()),
          "non-finite")
    x = sample[:, :, 0]
    true_mean = pi0 * mu0 + (1 - pi0) * mu1
    true_var = (pi0 * (sigma0**2 + (mu0 - true_mean) ** 2)
                + (1 - pi0) * (sigma1**2 + (mu1 - true_mean) ** 2))
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    m = {
        "elapsed_s": elapsed,
        "x_mean": float(x.mean()),
        "x_var": float(x.var(unbiased=False)),
        "z_freq": float(sample[:, :, 1].mean()),
        "rhat_mean": float(rhat.mean()),
        "ess_mean": float(ess.mean()),
    }
    del sample, x
    check("gibbs x mean", abs(m["x_mean"] - true_mean) <= 0.05, m["x_mean"])
    check("gibbs x var", abs(m["x_var"] - true_var) <= 0.25, m["x_var"])
    check("gibbs z freq", abs(m["z_freq"] - (1 - pi0)) <= 0.02, m["z_freq"])
    check("gibbs rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    m["draws_per_sec"] = MH_CHAINS * GIBBS_COLLECT / elapsed
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["block_us"] = elapsed / per_run * 1e6
    say("gibbs_main_path", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    return g, counts


def within_tol(a, b) -> torch.Tensor:
    """Per element: within MH_RTOL/MH_ATOL of ``b``, or equal."""
    a, b = a.double(), b.double()
    return ((a - b).abs() <= MH_ATOL + MH_RTOL * b.abs()) | (a == b)


def logp_within(got, want, rounding) -> torch.Tensor:
    """``within_tol`` widened by twice ``rounding``, a transformed
    density's float32 rounding (``CoordinateTransform.density_rounding``)
    that a kernel and its twin each stay within."""
    return ((got - want).double().abs()
            <= MH_ATOL + MH_RTOL * want.double().abs() + 2 * rounding)


def phase_mh_kernel(mh, label: str, k_steps: int, seed: int,
                    chain0: int = 0) -> dict:
    """Kernel 5 against its twin for one K-step block from the path's
    equilibrium state, same key and first global chain ``chain0``, on the
    sampler's kernel target (the transformed instance under a transform,
    its logp held within ``logp_within``): positions, logp and accepts (a
    row that moved) per chain. At ``chain0`` != 0 the check alone: no
    times."""
    s = mh.state
    hk = torch.empty((k_steps,) + tuple(s.positions.shape),
                     dtype=s.positions.dtype, device=s.positions.device)
    hp = torch.empty_like(hk)
    args = (mh.kernel_target, mh.proposal, s.positions, s.logp, seed, 0,
            k_steps)
    outk = mh_multistep(*args, hk, chain0=chain0)
    outp = mh_multistep_plain(*args, hp, chain0=chain0)
    torch.cuda.synchronize()

    def accepts(h):
        prev = torch.cat([s.positions[None], h[:-1]], dim=0)
        return (h != prev).any(dim=2)

    acc_k = accepts(hk)
    same_acc = (acc_k == accepts(hp)).all(dim=0)
    pos_ok = (within_tol(hk, hp).all(dim=2).all(dim=0)
              & within_tol(outk[0], outp[0]).all(dim=1))
    logp_ok = within_tol(outk[1], outp[1])
    shares = {
        "accepts": float(same_acc.float().mean()),
        "positions": float((same_acc & pos_ok).float().mean()),
        "logp": float((same_acc & logp_ok).float().mean()),
        "positions_equal": float(
            (hk == hp).all(dim=2).all(dim=0).float().mean()),
    }
    agree = same_acc & pos_ok
    if mh.transform is not None:  # the transformed density's rounding
        logp_ok = logp_within(outk[1], outp[1],
                              mh.transform.density_rounding(mh.target,
                                                            outp[0]))
        shares["logp"] = float((same_acc & logp_ok).float().mean())
    err = max(max_abs_err(hk.transpose(0, 1).double(),
                          hp.transpose(0, 1).double(), agree),
              max_abs_err(outk[1], outp[1], agree))
    say("mh_kernel", path=label, K=k_steps, chains=s.positions.shape[0],
        chain0=chain0, dtype=str(s.positions.dtype), accept_rate=float(
            acc_k.float().mean()),
        **{f"share_{k}": v for k, v in shares.items()}, max_abs_err=err)
    for name in ("accepts", "positions", "logp"):
        check(f"mh kernel {label} {name}", shares[name] >= MH_SHARE,
              shares[name])
    if s.positions.dtype == torch.int32:
        check(f"mh kernel {label} int positions equal",
              shares["positions_equal"] >= MH_SHARE, shares)
    if chain0:
        return {"err": err}
    return {"err": err, "ms": cuda_ms(lambda: mh_multistep(*args, hk), 20),
            "plain_ms": cuda_ms(lambda: mh_multistep_plain(*args, hp), 2),
            "device_ms": device_ms_per_launch(
                lambda: mh_multistep(*args, hk), "mh_multistep_kernel")}


def phase_gibbs_kernel(g, seed: int, chain0: int = 0) -> dict:
    """Kernel 6 against its twin for one K-sweep block from the Gibbs
    equilibrium state, same key and first global chain ``chain0``: x
    within tolerance and z equal per chain. At ``chain0`` != 0 the check
    alone: no times."""
    pos = g.state.positions
    hk = torch.empty((GIBBS_K,) + tuple(pos.shape), device=pos.device)
    hp = torch.empty_like(hk)
    args = (g.conditional, pos, seed, 0, GIBBS_K)
    outk = gibbs_multistep(*args, hk, chain0=chain0)
    outp = gibbs_multistep_plain(*args, hp, chain0=chain0)
    torch.cuda.synchronize()
    x_ok = (within_tol(hk[..., 0], hp[..., 0]).all(dim=0)
            & within_tol(outk[:, 0], outp[:, 0]))
    z_ok = (hk[..., 1] == hp[..., 1]).all(dim=0)
    shares = {
        "x": float(x_ok.float().mean()),
        "z": float(z_ok.float().mean()),
        "both": float((x_ok & z_ok).float().mean()),
        "x_equal": float((hk[..., 0] == hp[..., 0]).all(dim=0)
                         .float().mean()),
    }
    err = max_abs_err(hk.transpose(0, 1), hp.transpose(0, 1), x_ok & z_ok)
    say("gibbs_kernel", K=GIBBS_K, chains=pos.shape[0], chain0=chain0,
        z_freq=float(hk[..., 1].mean()),
        **{f"share_{k}": v for k, v in shares.items()}, max_abs_err=err)
    check("gibbs kernel x and z", shares["both"] >= MH_SHARE, shares)
    if chain0:
        return {"err": err}
    return {"err": err, "ms": cuda_ms(lambda: gibbs_multistep(*args, hk), 20),
            "plain_ms": cuda_ms(lambda: gibbs_multistep_plain(*args, hp), 2)}


def k56_cases(dev) -> dict:
    """Kernels 5 and 6 at the main paths' shapes, from states drawn from
    their targets (the equilibrium's cost per step): label -> (wrapper,
    leading arguments, state, K)."""
    gen = torch.Generator(device=dev).manual_seed(606)
    c = MH_CHAINS
    gauss = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    x = torch.randn((c, 2), generator=gen, device=dev)
    pois = mt.poisson_target(POISSON_LAM)
    k = torch.poisson(torch.full((c, 1), POISSON_LAM, device=dev),
                      generator=gen).to(torch.int32)
    mu0, sigma0, mu1, sigma1, pi0 = MIX
    z = (torch.rand(c, generator=gen, device=dev) >= pi0).float()
    n = torch.randn(c, generator=gen, device=dev)
    xm = torch.where(z > 0, mu1 + sigma1 * n, mu0 + sigma0 * n)
    return {
        "gauss2d": (mh_multistep, (gauss, mt.isotropic_gaussian_proposal(
            1.0)), (x, gauss.batch_logp(x)), MH_K),
        "poisson": (mh_multistep, (pois, mt.random_walk_int_proposal()),
                    (k, pois.batch_logp(k)), POISSON_K),
        "gibbs": (gibbs_multistep, (mt.gaussian_mixture_conditional(*MIX),),
                  (torch.stack([xm, z], dim=1),), GIBBS_K),
    }


def phase_k56_alone(dev, reps: int = 100) -> None:
    """``--profile``: Kernels 5 and 6 alone at the main paths' shapes, each
    over ``reps`` back-to-back launches: device µs per launch
    (``torch.profiler``, over the launches it recorded) and ms per launch
    by CUDA events."""
    for label, (kernel, lead, state, k) in k56_cases(dev).items():
        hist = torch.empty((k,) + tuple(state[0].shape),
                           dtype=state[0].dtype, device=dev)

        def launch():
            return kernel(*lead, *state, 0x5EED_0606, 0, k, hist)

        _, _, by_name = device_profile(lambda: [launch()
                                                for _ in range(reps)],
                                                expect="multistep_kernel")
        n, us = next(v for name, v in by_name.items()
                     if "multistep_kernel" in name)
        check(f"profiled {label} launches", 0 < n <= reps, n)
        say("k56_alone", path=label, K=k, chains=MH_CHAINS, calls=reps,
            recorded=n, device_us_per_call=us / n,
            event_ms=cuda_ms(launch, reps))


#: device µs under which a launch cannot be a [C, D] pass of the separable
#: stage: reading and writing 41 MB takes 24 µs at 3.35 TB/s
SEP_CD_US = 5.0


def phase_runs_profile(runs, sep_steps: int | None = None) -> None:
    """``--profile``: one run of each ``(label, fn)`` path under
    ``torch.profiler``: device time by kernel and the idle share. With
    ``sep_steps`` (a separable run of that many steps), also the launches
    a step and a check that nothing launched once a step besides Kernel 7
    is a ``[C, D]`` pass (every such launch under SEP_CD_US): a kernel
    recorded on at least three quarters of the steps (the profiler misses
    a few launches; the recorded rows' copy and map run on half of them,
    one a kept draw)."""
    for label, fn in runs:
        wall, busy, by_name = device_profile(fn)
        say(f"{label}_profile_run", wall_s=repr(wall),
            device_busy_us=repr(busy), idle_share=1.0 - busy / (wall * 1e6),
            kernel_names=len(by_name))
        for name, (n, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:6]:
            say(f"{label}_profile_kernel", name=repr(name[:60]), count=n,
                device_us=us, per_launch_us=us / n, share_of_busy=us / busy)
        if sep_steps is None:
            continue
        per_step = {name: (n, us / n) for name, (n, us) in by_name.items()
                    if 4 * n >= 3 * sep_steps
                    and "hmc_separable_kernel" not in name}
        say(f"{label}_profile_per_step", steps=sep_steps,
            launches_per_step=sum(n for n, _ in by_name.values()) / sep_steps,
            others=repr({k[:60]: v for k, v in per_step.items()}))
        check(f"{label} no [C, D] kernel a step beside Kernel 7",
              all(us < SEP_CD_US for _, us in per_step.values()), per_step)


def phase_sep_main_path(dev):
    """The large-D stage of bench.py:553-660 through the public entry
    point on both tiers: a burn-in run and the timed run, the gates of
    bench.py:635-640 and the launch counts of both runs. Returns the
    separable tier's sampler (its cubes freed), its counts and the metrics
    of both tiers."""
    out, counts = {}, None
    for tier in ("separable", False):
        reset_counts()
        h = mt.HMC(mt.standard_normal(),
                   mt.init_with_seed(SEP_CHAINS, SEP_DIM, seed=2, device=dev),
                   SEP_EPS, SEP_L, use_pallas=tier).seed(2)
        sample, elapsed = timed_run(h, SEP_COLLECT, SEP_COLLECT,
                                    time_major=True)
        c = read_counts()
        steps = 2 * SEP_COLLECT  # run(n, n) is 2n sampler steps
        label = "separable" if tier else "plain"
        if tier:
            counts, sep = c, h
            check("sep main-path launches: fused steps, no two-pass "
                  "launch and no plain twin",
                  c == counts_with(hmc_separable_step=2 * steps), c)
        else:
            check("sep plain tier launches no kernel",
                  not any(c[k] for k in KERNELS), c)
        check(f"sep {label} sample", tuple(sample.shape) == (
            SEP_COLLECT, SEP_CHAINS, SEP_DIM) and bool(
                torch.isfinite(sample).all()), tuple(sample.shape))
        var, mean = torch.var_mean(sample, correction=0)
        rhat, ess = mt.split_rhat_mean_ess(
            sample[:, :, :SEP_DIAG_DIM].contiguous(), time_major=True)
        moved = (sample[1:, :, 0] != sample[:-1, :, 0]).float().mean()
        m = {
            "elapsed_s": elapsed, "mean": float(mean), "var": float(var),
            "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
            "accept_rate": float(moved),
            "steps_per_sec": steps / elapsed,
            "draws_per_sec": steps * SEP_CHAINS / elapsed,
            "coordinate_updates_per_sec":
                steps * SEP_CHAINS * SEP_DIM / elapsed,
            "grad_evals_per_sec": steps * SEP_CHAINS * SEP_L / elapsed,
            "step_us": elapsed / steps * 1e6,
        }
        del sample, rhat, ess
        if not tier:
            del h
        torch.cuda.empty_cache()
        check(f"sep {label} mean", abs(m["mean"]) < 0.02, m["mean"])
        check(f"sep {label} var", abs(m["var"] - 1.0) < 0.05, m["var"])
        check(f"sep {label} rhat", 0.95 <= m["rhat_mean"] <= 1.05,
              m["rhat_mean"])
        check(f"sep {label} ess floor",
              m["ess_mean"] >= 0.02 * SEP_CHAINS * SEP_COLLECT,
              (m["ess_mean"], SEP_CHAINS * SEP_COLLECT))
        out[label] = m
    out["separable"]["speedup_vs_plain"] = (out["plain"]["elapsed_s"]
                                            / out["separable"]["elapsed_s"])
    for label, m in out.items():
        say(f"sep_main_path_{label}", **{k: repr(v) for k, v in m.items()},
            **(dict(launches_per_run=2 * SEP_COLLECT, **counts)
               if label == "separable" else {}))
    return sep, counts, out


def phase_sep_l40(dev) -> dict:
    """The L-scaling sub-stage of bench.py:668-700 on both tiers: the
    moment gates, the times and Kernel 7's launch count."""
    out = {}
    for tier in ("separable", False):
        label = "separable" if tier else "plain"
        reset_counts()
        h = mt.HMC(mt.standard_normal(),
                   mt.init_with_seed(SEP_CHAINS, SEP_DIM, seed=3, device=dev),
                   SEP_EPS40, SEP_L40, use_pallas=tier).seed(3)
        cube, elapsed = timed_run(h, SEP_COLLECT40, SEP_COLLECT40,
                                  time_major=True)
        c = read_counts()
        steps = 2 * SEP_COLLECT40
        check(f"sep L40 {label} launches", c == counts_with(
            hmc_separable_step=2 * steps) if tier else not any(
                c[k] for k in KERNELS), c)
        var, mean = torch.var_mean(cube, correction=0)
        m = {"elapsed_s": elapsed, "mean": float(mean), "var": float(var),
             "draws_per_sec": steps * SEP_CHAINS / elapsed,
             "grad_evals_per_sec": steps * SEP_CHAINS * SEP_L40 / elapsed,
             "launches": c["hmc_separable_step"]}
        del cube, h
        torch.cuda.empty_cache()
        check(f"sep L40 {label} finite and mean", abs(m["mean"]) < 0.03,
              m["mean"])
        check(f"sep L40 {label} var", abs(m["var"] - 1.0) < 0.06, m["var"])
        out[label] = m
    out["separable"]["speedup_vs_plain"] = (out["plain"]["elapsed_s"]
                                            / out["separable"]["elapsed_s"])
    for label, m in out.items():
        say(f"sep_L40_{label}", L=SEP_L40, eps=SEP_EPS40,
            **{k: repr(v) for k, v in m.items()},
            launches_per_run=2 * SEP_COLLECT40 if label == "separable" else 0)
    return out


def sep_tables(target, like) -> torch.Tensor:
    """The ``[n_tables, D]`` tables of ``target``'s ``sep_form`` as Kernel 7
    takes them (``[0, D]`` for none)."""
    tabs = target.sep_forms()[1]
    if not tabs:
        return like.new_empty((0, like.shape[1]))
    return torch.cat([t.to(like.device, like.dtype) for t in tabs])


def sep_kernel_check(target, pos, eps_value: float, label: str):
    """Kernel 7 against its twin for one L = 10 step from ``pos``, same
    key and step: the proposal per chain against the twin run in float64
    on the same draws (the kernel contracts FMAs), the three sums at rtol
    1e-5, and the same draws under a launch grid of 4x the D-tiles.
    Returns (max abs error, the launch's arguments)."""
    tables = sep_tables(target, pos)
    eps = torch.tensor([eps_value], device=pos.device)
    seed, step = 0x5EED_7777_0101, 5
    args = (target, pos, eps, SEP_L, seed, step, tables)
    got = hmc_separable(*args)
    want = hmc_separable_plain(*args)
    ref = hmc_separable_plain(target, pos.double(), eps.double(), SEP_L,
                              seed, step, tables.double())
    small = hmc_separable(*args, threads=64)
    torch.cuda.synchronize()
    shares = {
        "kernel_vs_f64": float(chain_agree(got[0], ref[0].float())
                               .float().mean()),
        "plain_vs_f64": float(chain_agree(want[0], ref[0].float())
                              .float().mean()),
        "kernel_vs_plain": float(chain_agree(got[0], want[0])
                                 .float().mean()),
    }

    def sums_close(a, b):
        a, b = a.double(), b.double()
        return bool(((a - b).abs() <= SEP_SUM_RTOL * b.abs()).all())

    names = ("logp", "ke0", "ke1")
    sums = {f"{n}_{w}": sums_close(a, b) for w, other in (
        ("f64", ref), ("plain", want), ("grid", got))
        for n, a, b in zip(names, (small if w == "grid" else got)[1:4],
                           other[1:4])}
    grid_equal = bool(torch.equal(small[0], got[0]))
    err = max_abs_err(got[0], want[0])
    say(label, chains=pos.shape[0], D=pos.shape[1], L=SEP_L,
        tables=tables.shape[0], scaled=target.cuda_scaled,
        **{f"share_{k}": v for k, v in shares.items()},
        **{f"sums_{k}_within_rtol": v for k, v in sums.items()},
        proposal_equal_across_grids=grid_equal, max_abs_err=err,
        max_abs_err_f64=max_abs_err(got[0].double(), ref[0]),
        max_rel_err_logp_f64=float(((got[1].double() - ref[1]).abs()
                                    / ref[1].abs()).max()))
    check(f"{label} proposal vs float64",
          shares["kernel_vs_f64"] >= max(shares["plain_vs_f64"] - 1e-3,
                                         0.999), shares)
    for k, v in sums.items():
        check(f"{label} sums {k}", v, k)
    check(f"{label} draws independent of the grid", grid_equal, "differ")
    return err, args


def decisions(new_pos, pos) -> torch.Tensor:
    """Per chain, whether a step moved it (accepted): a proposal equal to
    the start in every coordinate has probability 0 at these shapes."""
    return (new_pos != pos.to(new_pos.dtype)).any(dim=1)


def sep_step_check(target, pos, logp, eps_value: float, label: str,
                   chain0: int = 0):
    """Kernel 7's fused step against its twins for one L = 10 step from
    ``(pos, logp)``, same key and step: the accept decisions per chain
    (>= 99.9% equal to the float32 twin's and to the float64 twin's on the
    same draws, on the chains that are no tie: a float64 accept_logp
    within the float32 sums' error bound of log(u), where either decision
    is right; ties at most 10%; each decision the kernel's own, alpha_c >=
    u), and on the chains whose
    decision agrees the positions against the float64 twin and logp
    within rtol 1e-5; alpha_c of every chain whose float64 accept_logp is
    no NaN within 1e-2 of the float64 twin's; then the same step in
    clusters of 10 (threads=128) and in the two-pass
    form (threads=32: 40 tiles, past the cluster limit; one trajectory
    launch counted apart). Draws from global chain ``chain0`` on. Returns
    (max abs error against the float32 twin, the launch's arguments)."""
    tables = sep_tables(target, pos)
    eps = torch.tensor([eps_value], device=pos.device)
    seed, step = 0x5EED_7777_0202, 6
    args = (target, pos, logp, eps, SEP_L, seed, step, tables)
    got = hmc_separable_step(*args, chain0=chain0)
    want = hmc_separable_step_plain(*args, chain0=chain0)
    ref = hmc_separable_step_plain(target, pos.double(), logp.double(),
                                   eps.double(), SEP_L, seed, step,
                                   tables.double(), chain0=chain0)
    other = {"clusters_of_10": hmc_separable_step(*args, threads=128,
                                                  chain0=chain0)}
    check(f"{label} threads=32 is past the cluster limit",
          not sep_fused(pos.shape[1], 32), pos.shape[1])
    n_two = hmc_separable.launches
    other["two_pass"] = hmc_separable_step(*args, threads=32, chain0=chain0)
    check(f"{label} two-pass form: one trajectory launch",
          hmc_separable.launches == n_two + 1, hmc_separable.launches - n_two)
    torch.cuda.synchronize()
    # the float64 sums and the ties
    _, lp_prop, ke0, ke1, _ = hmc_separable_plain(
        target, pos.double(), eps.double(), SEP_L, seed, step,
        tables.double(), chain0=chain0)
    lp64 = logp.double()
    mag = lp64.abs() + lp_prop.abs() + ke0 + ke1
    u = accept_uniforms(pos.shape[0], step, seed, pos.device, chain0)
    # a float32 sum of D terms in (log2(D) + 8) rounds errs by at most
    # that many ulps of the terms' magnitude
    ulps = (math.log2(pos.shape[1]) + 8) * 2.0 ** -24
    accept_logp64 = (-lp64 + ke0) - (-lp_prop + ke1)
    tie = (accept_logp64 - u.double().log()).abs() <= ulps * mag
    acc_k, acc_p, acc_r = (decisions(o[0], pos) for o in (got, want, ref))
    same = acc_k == acc_r
    # each decision is the kernel's own: a chain moved iff alpha_c >= u,
    # up to the rounding of expf and logf
    own = (acc_k == (got[2] >= u)) | ((got[2] - u).abs() <= 1e-6)

    def share(ok, where):
        return float(ok[where].float().mean()) if bool(where.any()) else 1.0

    shares = {
        "same_decision_vs_plain": share(acc_k == acc_p, ~tie),
        "same_decision_vs_f64": share(same, ~tie),
        "positions_vs_f64": share(chain_agree(got[0], ref[0].float()),
                                  same),
    }
    for k, o in other.items():
        shares[f"{k}_same_positions"] = share((o[0] == got[0]).all(dim=1),
                                              ~tie)
    logp_ok = (got[1].double() - ref[1]).abs() <= SEP_SUM_RTOL * ref[1].abs()
    shares["logp_vs_f64"] = share(logp_ok, same)
    # alpha_c does not depend on the decision: every chain with a number
    # (a NaN or inf of the kernel's own fails the gate)
    alpha_d = (got[2].double() - ref[2]).abs()[~accept_logp64.isnan()]
    alpha_err = float(alpha_d.max()) if alpha_d.numel() else 0.0
    err = max_abs_err(got[0], want[0], acc_k == acc_p)
    say(label, chains=pos.shape[0], D=pos.shape[1], L=SEP_L,
        tables=tables.shape[0], scaled=target.cuda_scaled, chain0=chain0,
        accept_rate=float(acc_k.float().mean()),
        mean_alpha=float(got[2].mean()), ties=int(tie.sum()),
        **{f"share_{k}": v for k, v in shares.items()},
        max_abs_err=err,
        max_abs_err_f64=max_abs_err(got[0].double(), ref[0], same),
        alpha_max_abs_err_f64=alpha_err, alpha_atol=SEP_ALPHA_ATOL)
    check(f"{label} ties at most 10%", float(tie.float().mean()) <= 0.1,
          int(tie.sum()))
    check(f"{label} alpha_c within {SEP_ALPHA_ATOL} of the float64 twin",
          alpha_err <= SEP_ALPHA_ATOL, alpha_err)
    check(f"{label} decisions follow alpha_c and u", bool(own.all()),
          int((~own).sum()))
    for k, v in shares.items():
        check(f"{label} {k}", v >= 0.999, shares)
    return err, args


def phase_sep_kernel(sep, dev) -> dict:
    """Kernel 7 against its twins for one step from the stage's
    equilibrium state (:func:`sep_kernel_check`, the trajectory-only form;
    :func:`sep_step_check`, the fused step), then the times of the fused
    step, its twin and the trajectory-only form at L = 10 and 40."""
    target, pos = sep.target, sep.state.positions
    sep_kernel_check(target, pos, SEP_EPS, "sep_kernel")
    err, args = sep_step_check(target, pos, sep.state.logp, SEP_EPS,
                               "sep_step")
    traj = (target, pos) + args[3:]
    t = {"err": err,
         "ms": cuda_ms(lambda: hmc_separable_step(*args), 20),
         "plain_ms": cuda_ms(lambda: hmc_separable_step_plain(*args), 3),
         "ms_trajectory_only": cuda_ms(lambda: hmc_separable(*traj), 20)}
    args40 = args[:3] + (torch.tensor([SEP_EPS40], device=dev), SEP_L40,
                         *args[5:])
    t["ms_L40"] = cuda_ms(lambda: hmc_separable_step(*args40), 20)
    t["plain_ms_L40"] = cuda_ms(lambda: hmc_separable_step_plain(*args40), 3)
    say("sep_times", shape=f"C={SEP_CHAINS},D={SEP_DIM}",
        **{k: repr(v) for k, v in t.items() if k != "err"})
    return t


def pt_mixture() -> "mt.models.Target":
    """The tempering stage's target, built as bench.py:863-880 builds its
    own: the 0.3/0.7 mixture of N(-8, 0.5^2) and N(8, 0.5^2), naming the
    CUDA mixture functor."""
    lw0, lw1 = math.log(1 - PT_W_PLUS), math.log(PT_W_PLUS)

    def logp(x):
        a = lw0 - 0.5 * ((x[..., 0] + 8.0) / 0.5) ** 2
        b = lw1 - 0.5 * ((x[..., 0] - 8.0) / 0.5) ** 2
        return torch.logaddexp(a, b)

    return mt.models.Target(logp=logp, cuda_functor="gaussian_mixture_1d",
                            cuda_params=(lw0, -8.0, 0.5, lw1, 8.0, 0.5))


def phase_pt_main_path(dev):
    """The tempering stage of bench.py:858-909 through the public entry
    point on both tiers: warm-up and timed run, the gates of
    bench.py:890-898 and the launch counts of both runs. Returns the
    fused tier's sampler, its counts and the metrics of both tiers."""
    out, counts = {}, None
    for tier in ("full", False):
        label = "full" if tier else "plain"
        reset_counts()
        pt = mt.ParallelTempering(
            pt_mixture(), torch.full((PT_CHAINS, 1), -8.0, device=dev),
            betas=mt.geometric_betas(PT_TEMPS, 0.01), proposal_std=1.0,
            steps_per_call=PT_K, use_pallas=tier).seed(5)
        sample, elapsed = timed_run(pt, PT_COLLECT, 0, time_major=True)
        c = read_counts()
        per_run = PT_COLLECT // PT_K
        if tier:
            counts, fused = c, pt
            check("pt main-path launches and no plain twin",
                  c == counts_with(pt_multistep=2 * per_run), c)
        else:
            check("pt plain tier launches no kernel",
                  not any(c[k] for k in KERNELS), c)
        check(f"pt {label} sample", tuple(sample.shape) == (
            PT_COLLECT, PT_CHAINS, 1) and bool(torch.isfinite(sample).all()),
            tuple(sample.shape))
        xs = sample.reshape(-1)
        plus = xs[xs > 0].double()
        swap = pt.swap_acceptance
        m = {
            "elapsed_s": elapsed,
            "mode_weight": float((xs > 0).float().mean()),
            "plus_mean": float(plus.mean()),
            "plus_std": float(plus.std(unbiased=False)),
            "swap_acceptance": [float(v) for v in swap],
            "cold_draws_per_sec": PT_CHAINS * PT_COLLECT / elapsed,
            "replica_updates_per_sec":
                PT_CHAINS * PT_TEMPS * PT_COLLECT / elapsed,
            "block_us": elapsed / per_run * 1e6,
        }
        del sample, xs, plus
        check(f"pt {label} mode weight",
              abs(m["mode_weight"] - PT_W_PLUS) <= 0.05, m["mode_weight"])
        check(f"pt {label} mode mean", abs(m["plus_mean"] - 8.0) <= 0.05,
              m["plus_mean"])
        check(f"pt {label} mode std", abs(m["plus_std"] - 0.5) <= 0.05,
              m["plus_std"])
        check(f"pt {label} swap rates alive", bool((swap > 0.05).all()),
              m["swap_acceptance"])
        out[label] = m
    out["full"]["speedup_vs_plain"] = (out["plain"]["elapsed_s"]
                                       / out["full"]["elapsed_s"])
    for label, m in out.items():
        say(f"pt_main_path_{label}", **{k: repr(v) for k, v in m.items()},
            **(dict(launches_per_run=PT_COLLECT // PT_K, **counts)
               if label == "full" else {}))
    return fused, counts, out


def phase_pt_kernel(pt, seed: int, std: float = 1.0,
                    label: str = "pt_kernel", exact: bool = True,
                    chain0: int = 0) -> dict:
    """Kernel 8 against its twin for one K-step block from the stage's
    equilibrium state, same key, on the sampler's kernel target at cold
    scale ``std``: positions, logp, swap EWMA and the history rows equal
    per chain; under a transform (the transformed instance, whose density
    differs from the twin's within its float32 rounding) positions and
    history within MH_RTOL/MH_ATOL, logp within that and twice the
    density's float32 rounding (``logp_within``). Without ``exact`` (a
    user density's C++ against its batch form) every field within
    MH_RTOL/MH_ATOL. Draws from global chain ``chain0`` on; at ``chain0``
    != 0 the check alone: no times."""
    s = pt.state
    c = s.positions.shape[2]
    hk = torch.empty((PT_K, c, 1), device=s.positions.device)
    hp = torch.empty_like(hk)
    lad = make_ladder(pt.betas, std, 1, s.positions.device)
    args = (pt.kernel_target, s.positions, s.raw_logp, s.swap_accept,
            s.parity, lad, seed, 0, PT_K, 1)
    got = pt_multistep(*args, hk, chain0=chain0)
    want = pt_multistep_plain(*args, hp, chain0=chain0)
    torch.cuda.synchronize()
    if not exact:
        same, logp_ok = within_tol, within_tol(got[1], want[1])
    elif pt.transform is None:
        same, logp_ok = (lambda a, b: a == b), (got[1] == want[1])
    else:
        t, _, c = want[0].shape
        rounding = pt.transform.density_rounding(
            pt.target, want[0].permute(0, 2, 1).reshape(t * c, -1))
        rounding = rounding.reshape(t, c)
        same, logp_ok = within_tol, logp_within(got[1], want[1], rounding)
    equal = {
        "positions": same(got[0], want[0]).all(1).all(0),
        "logp": logp_ok.all(0),
        "swap_accept": (got[2] == want[2]).all(0) if exact
        else within_tol(got[2], want[2]).all(0),
        "history": same(hk, hp).all(2).all(0),
    }
    shares = {k: float(v.float().mean()) for k, v in equal.items()}
    same = equal["positions"] & equal["history"]
    err = max(max_abs_err(hk.transpose(0, 1), hp.transpose(0, 1)),
              max_abs_err(got[0], want[0]))
    say(label, K=PT_K, T=PT_TEMPS, chains=c, chain0=chain0, parity=s.parity,
        accept_rate=float((hk[1:] != hk[:-1]).float().mean()),
        **{f"share_equal_{k}": v for k, v in shares.items()},
        share_all_equal=float((same & equal["logp"]
                               & equal["swap_accept"]).float().mean()),
        max_abs_err=err)
    for k, v in shares.items():
        check(f"{label} {k} equal", v >= MH_SHARE, shares)
    if chain0:
        return {"err": err}
    return {"err": err, "ms": cuda_ms(lambda: pt_multistep(*args, hk), 20),
            "plain_ms": cuda_ms(lambda: pt_multistep_plain(*args, hp), 2),
            "device_ms": device_ms_per_launch(
                lambda: pt_multistep(*args, hk), "pt_multistep_kernel")}


def phase_mala_tuned(dev):
    """The tuned-MALA stage of bench.py:732-779 through the public entry
    points: ``MALA(..., use_pallas="full", steps_per_call=16).seed(13)
    .tuned(256)`` (Kernel 1 under dual averaging), then ``run(2048, 0)``
    twice (Kernel 2 at L = 1), the gates of bench.py:757-766 and the
    launch counts of the whole path. Returns the sampler, its counts and
    its metrics."""
    target = mt.diffable_gaussian2d(MALA_MEAN, NUTS_COV)
    init = mt.init_with_seed(MALA_CHAINS, 2, seed=13, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    ml = mt.MALA(target, init, step_size=1.0, use_pallas="full",
                 steps_per_call=MALA_K).seed(13).tuned(MALA_ADAPT)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    sample, elapsed = timed_run(ml, MALA_COLLECT, 0, time_major=True)
    counts = read_counts()
    per_run = MALA_COLLECT // MALA_K
    check("mala path launches and no plain twin", counts == counts_with(
        leapfrog_trajectory=MALA_ADAPT, hmc_multistep=2 * per_run), counts)
    check("mala sample", tuple(sample.shape) == (
        MALA_COLLECT, MALA_CHAINS, 2) and bool(torch.isfinite(sample).all()),
        tuple(sample.shape))
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    var, mean = torch.var_mean(sample, dim=(0, 1), correction=0)
    total = MALA_CHAINS * MALA_COLLECT
    m = {
        "eps_tuned": ml.step_size, "tune_s": tune_s, "elapsed_s": elapsed,
        "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
        "mean": [float(v) for v in mean], "var": [float(v) for v in var],
        "accept_rate": float((sample[1:] != sample[:-1]).any(dim=2)
                             .float().mean()),
    }
    del sample
    check("mala tuned eps sane", 0.2 <= m["eps_tuned"] <= 5.0,
          m["eps_tuned"])
    check("mala rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    check("mala ess floor", m["ess_mean"] >= 0.005 * total,
          (m["ess_mean"], total))
    for d in range(2):
        check(f"mala mean[{d}]", abs(m["mean"][d] - MALA_MEAN[d]) <= 0.05,
              m["mean"])
        check(f"mala var[{d}]", abs(m["var"][d] - MALA_VAR[d]) <= 0.3,
              m["var"])
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = total / elapsed
    m["block_us"] = elapsed / per_run * 1e6
    say("mala_tuned", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    return ml, counts, m


def phase_mala_kernel(ml, dev, profile: bool = False) -> dict:
    """Kernel 2 at L = 1 against its twin for one K = 16 block from the
    MALA stage's equilibrium (:func:`phase_multistep`), and both times at
    the stage's shapes (CUDA events); then Kernel 1 at L = 1 there, the
    trajectory ``tuned(256)`` launches, and its twin's time; with
    ``profile``, Kernel 1's device µs a launch over 50 launches
    (``torch.profiler``, over the launches it recorded)."""
    target, s, eps = ml.kernel_target, ml.state, ml.step_size
    err = phase_multistep(target, s, dev, eps, label="multistep_mala",
                          n_leapfrog=1)
    eps_k = torch.full((MALA_K,), eps, device=dev)
    hist = torch.empty((MALA_K,) + tuple(s.positions.shape), device=dev)
    args = (target, s.positions, s.logp, s.grad, eps_k, 1, 1, 0, hist)
    gen = torch.Generator(device=dev).manual_seed(23)
    mom = torch.randn(s.positions.shape, generator=gen, device=dev)
    lf_args = (target, s.positions, mom, s.grad,
               torch.tensor([eps], device=dev), 1)
    t = {"err": err, "ms": cuda_ms(lambda: hmc_multistep(*args), 50),
         "plain_ms": cuda_ms(lambda: hmc_multistep_plain(*args), 3),
         "leapfrog_ms": cuda_ms(lambda: leapfrog_trajectory(*lf_args), 50),
         "leapfrog_plain_ms": cuda_ms(lambda: leapfrog_trajectory_plain(
             *lf_args[:4], lf_args[4][0], 1), 5)}
    if profile:
        reps = 50
        _, _, by_name = device_profile(
            lambda: [leapfrog_trajectory(*lf_args) for _ in range(reps)],
            expect="leapfrog_kernel")
        n, us = next(v for k, v in by_name.items() if "leapfrog_kernel" in k)
        check("profiled leapfrog L=1 launches", 0 < n <= reps, n)
        t["leapfrog_device_us"] = us / n
        say("profile_leapfrog_mala", L=1, calls=reps, recorded=n,
            device_us_per_call=us / n)
    say("mala_times", shape=f"C={MALA_CHAINS},D=2,L=1,K={MALA_K}",
        **{k: repr(v) for k, v in t.items() if k != "err"})
    return t


def phase_mh_tuned(dev):
    """The MH stage's configuration (bench.py:391-431: Gaussian2D, 65,536
    chains, K = 16) started at a 25-sigma walk and ``tuned(256)``, then
    ``run(2048, 0)`` twice through Kernel 5 at the tuned scale: the gates
    of bench.py:416-421, a move rate in [0.15, 0.32]
    (tests/test_mh.py:160-167) and the launch counts of the whole path."""
    target = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    init = mt.init_with_seed(MH_CHAINS, 2, seed=8, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    mh = mt.MetropolisHastings(
        target, mt.isotropic_gaussian_proposal(MH_TUNED_STD), init,
        use_pallas="full", steps_per_call=MH_K).seed(8).tuned(MH_TUNED_ADAPT)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    sample, elapsed = timed_run(mh, MH_COLLECT, 0, time_major=True)
    counts = read_counts()
    per_run = MH_COLLECT // MH_K
    check("mh tuned launches and no plain twin",
          counts == counts_with(mh_multistep=2 * per_run), counts)
    check("mh tuned sample", tuple(sample.shape) == (
        MH_COLLECT, MH_CHAINS, 2) and bool(torch.isfinite(sample).all()),
        tuple(sample.shape))
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    var, mean = torch.var_mean(sample, dim=(0, 1), correction=0)
    total = MH_CHAINS * MH_COLLECT
    m = {
        "scale_factor": mh.scale_factor,
        "proposal_std": mh.proposal.cuda_params[0], "tune_s": tune_s,
        "elapsed_s": elapsed, "rhat_mean": float(rhat.mean()),
        "ess_mean": float(ess.mean()), "mean": [float(v) for v in mean],
        "var": [float(v) for v in var],
        "move_rate": float((sample[1:] != sample[:-1]).any(dim=2)
                           .float().mean()),
    }
    del sample
    check("mh tuned rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    for d in range(2):
        check(f"mh tuned mean[{d}]", abs(m["mean"][d]) <= 0.03, m["mean"])
        check(f"mh tuned var[{d}]", abs(m["var"][d] - 1.0) <= 0.05,
              m["var"])
    check("mh tuned ess floor", m["ess_mean"] >= 0.02 * total,
          (m["ess_mean"], total))
    check("mh tuned move rate", 0.15 <= m["move_rate"] <= 0.32,
          m["move_rate"])
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = total / elapsed
    m["block_us"] = elapsed / per_run * 1e6
    say("mh_tuned", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    return mh, counts, m


def sigma_table_normal(sigma: torch.Tensor) -> "mt.models.Target":
    """The heterogeneous normal -sum((x / sigma)^2) / 2, built as
    tests/test_torch_separable.py:55-64 builds it: ``sigma`` its one
    ``sep_form`` table, naming the ``sigma_table_normal`` functor."""

    def tile(x, s):
        return torch.sum(-0.5 * (x / s.to(x.dtype)) ** 2, dim=-1)

    return mt.models.Target(logp=lambda x: tile(x, sigma),
                            sep_form=(tile, (sigma,)),
                            cuda_functor="sigma_table_normal")


def phase_sep_warmed_up(dev):
    """The separable stage's shape (bench.py:553-560: 1,024 chains,
    D = 10,000, L = 10, eps 0.1 to start) on ``sigma_table_normal`` with
    sigma_d = logspace(-1, 1, D): ``HMC(use_pallas="separable").seed(2)
    .warmed_up(128, "diag")`` (Kernel 7 while tuning, then its scaled
    instance), then ``run(128, 128, time_major=True)`` twice, the gates of
    bench.py:635-640 on z = x / sigma and the launch counts of the whole
    path. Then the tuner's check: 32 steps at the tuned eps through
    ``step_eps`` (the scaled instance, counted apart) average an
    acceptance within 0.10 of 0.651."""
    sigma = torch.logspace(-1, 1, SEP_DIM, dtype=torch.float32, device=dev)
    target = sigma_table_normal(sigma)
    init = mt.init_with_seed(SEP_CHAINS, SEP_DIM, seed=2, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    w = mt.HMC(target, init, SEP_EPS, SEP_L, use_pallas="separable").seed(
        2).warmed_up(SEP_WARM_ADAPT, "diag")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check("sep warmed_up whitens with the scaled form",
          w.kernel_target.cuda_scaled and w.metric.kind == "diag",
          w.metric)
    sample, elapsed = timed_run(w, SEP_COLLECT, SEP_COLLECT,
                                time_major=True)
    counts = read_counts()
    steps = 2 * SEP_COLLECT
    scaled = SEP_WARM_ADAPT + 2 * steps  # the second leg and both runs
    check("sep warmed_up launches and no plain twin", counts == counts_with(
        hmc_separable_step=SEP_WARM_ADAPT + scaled,
        hmc_separable_step_scaled=scaled), counts)
    check("sep warmed_up sample", tuple(sample.shape) == (
        SEP_COLLECT, SEP_CHAINS, SEP_DIM) and bool(
            torch.isfinite(sample).all()), tuple(sample.shape))
    z = sample.div_(sigma)
    var, mean = torch.var_mean(z, correction=0)
    rhat, ess = mt.split_rhat_mean_ess(z[:, :, :SEP_DIAG_DIM].contiguous(),
                                       time_major=True)
    scale_ratio = w.metric.scale / sigma
    m = {
        "eps_tuned": w.step_size, "warm_up_s": warm_s, "elapsed_s": elapsed,
        "mean": float(mean), "var": float(var),
        "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
        "accept_rate": float((z[1:, :, 0] != z[:-1, :, 0]).float().mean()),
        "metric_over_sigma_min": float(scale_ratio.min()),
        "metric_over_sigma_max": float(scale_ratio.max()),
        "steps_per_sec": steps / elapsed,
        "draws_per_sec": steps * SEP_CHAINS / elapsed,
        "coordinate_updates_per_sec": steps * SEP_CHAINS * SEP_DIM / elapsed,
        "step_us": elapsed / steps * 1e6,
    }
    del sample, z, rhat, ess
    torch.cuda.empty_cache()
    check("sep warmed_up z mean", abs(m["mean"]) < 0.02, m["mean"])
    check("sep warmed_up z var", abs(m["var"] - 1.0) < 0.05, m["var"])
    check("sep warmed_up rhat", 0.95 <= m["rhat_mean"] <= 1.05,
          m["rhat_mean"])
    check("sep warmed_up ess floor",
          m["ess_mean"] >= 0.02 * SEP_CHAINS * SEP_COLLECT,
          (m["ess_mean"], SEP_CHAINS * SEP_COLLECT))
    # the tuner's check, off the counted path
    key = w._next_key()
    eps = torch.tensor(w.step_size, device=dev)
    state, alphas = w.state, []
    for i in range(32):
        state, a = w._step_fn.step_eps(state, key._replace(step=i + 1), eps)
        alphas.append(a)
    m["accept_at_tuned_eps"] = float(torch.stack(alphas).mean())
    check("sep warmed_up acceptance at the tuned eps",
          abs(m["accept_at_tuned_eps"] - 0.651) <= 0.10,
          m["accept_at_tuned_eps"])
    say("sep_warmed_up", **{k: repr(v) for k, v in m.items()},
        launches_per_run=steps, **counts)
    return w, counts, m


def phase_sep_scaled_kernel(w, dev) -> dict:
    """Kernel 7's scaled instance against its twins for one step from the
    warmed-up stage's equilibrium (:func:`sep_kernel_check`,
    :func:`sep_step_check`), and the times of its fused step, its twin and
    its trajectory-only form (CUDA events); its device time alone is
    :func:`phase_k7_alone`'s (``--profile``)."""
    target, pos = w.kernel_target, w.state.positions
    sep_kernel_check(target, pos, w.step_size, "sep_scaled_kernel")
    err, args = sep_step_check(target, pos, w.state.logp, w.step_size,
                               "sep_scaled_step")
    traj = (target, pos) + args[3:]
    t = {"err": err, "ms": cuda_ms(lambda: hmc_separable_step(*args), 20),
         "plain_ms": cuda_ms(lambda: hmc_separable_step_plain(*args), 3),
         "ms_trajectory_only": cuda_ms(lambda: hmc_separable(*traj), 20)}
    say("sep_scaled_times", shape=f"C={SEP_CHAINS},D={SEP_DIM},L={SEP_L}",
        **{k: repr(v) for k, v in t.items() if k != "err"})
    return t


def phase_k7_alone(dev, reps: int = 20) -> dict:
    """Kernel 7 alone at the separable stage's shape (C = 1,024, D =
    10,000, L = 10, eps 0.1) from states drawn from each target: the
    standard normal, the sigma table (sigma_d = logspace(-1, 1, D)) and
    the sigma table whitened by its own sigma (the scaled instance). For
    each, the trajectory-only form (the two-pass form's first launch) and
    the fused step in its default clusters of 5 and in clusters of 10
    (threads=128), the fused steps chained over ``reps`` steps from the
    state.
    Device µs per launch over ``reps`` launches (``torch.profiler``) and ms
    per launch by CUDA events; returns the device µs by target and
    form."""
    gen = torch.Generator(device=dev).manual_seed(707)
    z = torch.randn((SEP_CHAINS, SEP_DIM), generator=gen, device=dev)
    sigma = torch.logspace(-1, 1, SEP_DIM, dtype=torch.float32, device=dev)
    eps = torch.tensor([SEP_EPS], device=dev)
    seed = 0x5EED_7070
    cases = {"standard_normal": (mt.standard_normal(), z),
             "sigma_table": (sigma_table_normal(sigma), z * sigma),
             "scaled_sigma_table": (mt.precondition_target(
                 sigma_table_normal(sigma), mt.Preconditioner(
                     "diag", scale=sigma)), z)}
    forms = {"fused": {}, "fused_clusters_of_10": dict(threads=128)}
    out = {}

    def profiled(fn, what):
        """Device µs a launch of Kernel 7 in ``fn``: the profiler can miss
        launches of a burst, so a call that recorded fewer than half is
        profiled again (three calls at most)."""
        for _ in range(3):
            _, _, by_name = device_profile(fn, expect="hmc_separable_kernel")
            n, us = next(v for name, v in by_name.items()
                         if "hmc_separable_kernel" in name)
            if 2 * n >= reps:
                break
        check(f"profiled Kernel 7 {what} launches", reps <= 2 * n <= 2 * reps,
              n)
        return n, us

    for label, (target, pos) in cases.items():
        tables = sep_tables(target, pos)
        logp = target.batch_logp(pos).float()
        runs = {"trajectory_only": lambda: [hmc_separable(
            target, pos, eps, SEP_L, seed, 3, tables) for _ in range(reps)]}
        for form, kw in forms.items():
            def chained(kw=kw):
                p, lp = pos.clone(), logp.clone()
                for i in range(reps):
                    p, lp, _ = hmc_separable_step(target, p, lp, eps, SEP_L,
                                                  seed, 3 + i, tables, **kw)
            runs[form] = chained
        out[label] = {}
        for form, fn in runs.items():
            n, us = profiled(fn, f"{label} {form}")
            out[label][form] = us / n
            say("k7_alone", target=label, form=form, C=SEP_CHAINS, D=SEP_DIM,
                L=SEP_L, calls=reps, recorded=n, device_us_per_call=us / n,
                event_ms=cuda_ms(fn, 1) / reps)
    return out


def flagship(dev, seed: int = 42):
    """A flagship sampler as the main path builds it, from ``seed``."""
    init = (mt.init_with_seed(N_CHAINS, DIM, seed=seed, device=dev) * 0.5
            + 1.0)
    return mt.HMC(mt.rosenbrock_nd(), init, STEP_SIZE, N_LEAPFROG,
                  use_pallas="full", jitter=JITTER,
                  steps_per_call=STEPS_PER_CALL).seed(seed)


def timed(fn):
    """``(fn(), seconds)``, the device synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tracked_run(sampler, n_collect: int, n_discard: int, time_major: bool):
    """The sampler's own runner with a fresh tracker and no display: what
    ``run_progress`` adds to ``run()`` before its ticks and RunStats."""
    tracker = mt.stats.tracker_init(sampler.n_chains, sampler.dim,
                                    device=sampler.state.positions.device)
    sampler.state, cube, _ = sampler._runner(
        sampler.state, sampler._next_key(), n_collect, n_discard,
        time_major=time_major, tracker=tracker)
    return cube


def phase_run_progress(dev):
    """The flagship through ``HMC.run_progress(8192, 8192, time_major=True)``
    against a twin sampler's ``run(8192, 8192, time_major=True)`` from the
    same seed, and the runner with a tracker alone ("tracked"), in turns:
    the cubes equal bit for bit, Kernel 2's launches (1,024 in each, no
    twin), the bench gates on the progress cube, its RunStats, the
    progress lines, the wall times and that of ``run_stats`` on the cube
    (which ``run_progress`` returns beside it). Returns the progress cube,
    the twin's cube and the counts."""
    per_run = 2 * N_COLLECT // STEPS_PER_CALL
    times = {"run_s": [], "run_progress_s": [], "tracked_s": []}
    cubes, text = {}, ""
    for drive in ("run", "run_progress", "tracked", "tracked",
                  "run_progress", "run"):
        sampler = flagship(dev)
        reset_counts()
        if drive == "run":
            cube, sec = timed(lambda: sampler.run(N_COLLECT, N_COLLECT,
                                                  time_major=True))
        elif drive == "tracked":
            cube, sec = timed(lambda: tracked_run(sampler, N_COLLECT,
                                                  N_COLLECT, True))
        else:
            out = io.StringIO()
            (cube, rs), sec = timed(lambda: sampler.run_progress(
                N_COLLECT, N_COLLECT, time_major=True, stream=out))
            text = out.getvalue()
        counts = read_counts()
        check(f"{drive} launches and no plain twin",
              counts == counts_with(hmc_multistep=per_run), counts)
        times[f"{drive}_s"].append(sec)
        if drive in cubes or drive == "tracked":
            check(f"{drive} cube repeats", torch.equal(
                cube, cubes.get(drive, cubes["run"])), drive)
        else:
            cubes[drive] = cube
        del cube, sampler
    sample, want = cubes["run_progress"], cubes["run"]
    equal = torch.equal(sample, want)
    check("run_progress cube equals run()'s", equal, "cubes differ")
    stats_s = [timed(lambda: mt.run_stats(want, time_major=True))[1]
               for _ in range(2)]
    m = hmc_gates(sample)
    lines = [ln for ln in text.splitlines() if ln.startswith("Global")]
    check("run_progress rendered", len(lines) >= 1
          and f"{2 * N_COLLECT}/{2 * N_COLLECT}" in lines[-1], lines[-1:])
    run_s = min(times["run_s"])
    say("run_progress", equal_to_run=equal, launches=per_run,
        run_launches=per_run, **{k: repr(v) for k, v in m.items()},
        **{k: repr(v) for k, v in times.items()},
        run_stats_s=repr(stats_s),
        ratio=repr(min(times["run_progress_s"]) / run_s),
        ratio_tracked=repr(min(times["tracked_s"]) / run_s),
        ratio_without_run_stats=repr(
            (min(times["run_progress_s"]) - min(stats_s)) / run_s),
        rendered=len(lines), last_global=repr(lines[-1]))
    say("run_progress_stats", ess=repr(str(rs.ess)),
        rhat=repr(str(rs.rhat)))
    return sample, want, counts


def phase_stream_run(want, dev) -> int:
    """``stream_run`` of the flagship, 8,192 draws after 8,192 in chunks of
    1,024: each chunk equals the same rows of the twin's ``run()`` cube
    ``want``; the tracker's acceptance and live R-hat beside run_stats'
    split R-hat. Returns Kernel 2's launches."""
    chunk = 1024
    seen = []

    def on_chunk(c, start):
        check(f"stream chunk {start}", torch.equal(
            c, want[start:start + chunk]), start)
        seen.append(start)

    sampler = flagship(dev)
    reset_counts()
    res, sec = timed(lambda: mt.stream_run(sampler, N_COLLECT, chunk,
                                           on_chunk, n_discard=N_COLLECT))
    counts = read_counts()
    per_run = 2 * N_COLLECT // STEPS_PER_CALL
    check("stream_run launches and no plain twin",
          counts == counts_with(hmc_multistep=per_run), counts)
    check("stream_run chunks", seen == list(range(0, N_COLLECT, chunk)),
          seen)
    rs = mt.run_stats(want, time_major=True)
    rhat, _ = mt.split_rhat_mean_ess(want, time_major=True)
    say("stream_run", chunks=len(seen), chunk=chunk, equal_to_run=True,
        launches=per_run, seconds=repr(sec),
        p_accept=repr(float(res.p_accept)),
        live_rhat=repr([float(v) for v in res.rhat]),
        split_rhat=repr([float(v) for v in rhat]),
        run_stats_rhat=repr(str(rs.rhat)))
    return per_run


def phase_summary_on_card(sample, dev) -> dict:
    """``summary`` and ``rank_normalized_diagnostics`` on the card (CUDA
    events, peak memory above the cubes) on the gate's [512, 2048, 3]
    sub-cube and on the last 512 draws of all 65,536 chains, 33,554,432
    draws a parameter (twice the 2**24 at which torch.quantile raised):
    every value finite, the rank R-hat under the gate, the summary's R-hat
    the diagnostics', and the sub-cube's summary against the same one on
    the CPU (mean, sd and quantiles at rtol 1e-4, ESS and MCSE at 1e-3,
    R-hat at 1e-5)."""
    out = {}
    cubes = (("gate_512x2048", gate_cube(sample)),
             ("tail_512x65536", sample[N_COLLECT - 512:]))
    for label, cube in cubes:
        res = {}
        for name, fn in (("diagnostics", mt.rank_normalized_diagnostics),
                         ("summary", mt.summary)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res[name] = fn(cube, time_major=True)
            end.record()
            end.synchronize()
            out[f"{label}_{name}_s"] = start.elapsed_time(end) * 1e-3
            out[f"{label}_{name}_peak_gib"] = (
                torch.cuda.max_memory_allocated() - base) / 2**30
        diag, summ = res["diagnostics"], res["summary"]
        for f in ("rhat", "ess_bulk", "ess_tail"):
            check(f"{label} diagnostics {f} finite",
                  bool(torch.isfinite(getattr(diag, f)).all()), f)
        for f in ("mean", "sd", "mcse_mean", "mcse_sd", "quantiles"):
            check(f"{label} summary {f} finite",
                  bool(torch.isfinite(getattr(summ, f)).all()), f)
        check(f"{label} summary rhat is the diagnostics'",
              torch.equal(summ.rhat, diag.rhat), (summ.rhat, diag.rhat))
        rank_rhat = float(diag.rhat.max())
        check(f"{label} rank-normalized rhat", rank_rhat <= 1.02, rank_rhat)
        out[f"{label}_rank_rhat_max"] = rank_rhat
        out[f"{label}_draws_per_param"] = cube.shape[0] * cube.shape[1]
        if label.startswith("gate"):
            cpu = mt.summary(cube.cpu(), time_major=True)
            for f, rtol in (("mean", 1e-4), ("sd", 1e-4),
                            ("quantiles", 1e-4), ("ess_bulk", 1e-3),
                            ("ess_tail", 1e-3), ("mcse_mean", 1e-3),
                            ("mcse_sd", 1e-3), ("rhat", 1e-5)):
                a, b = getattr(summ, f).cpu(), getattr(cpu, f)
                check(f"summary {f} card against CPU", torch.allclose(
                    a, b, rtol=rtol, atol=rtol), (a, b))
            print(str(summ), flush=True)
    say("summary_on_card", **{k: repr(v) for k, v in out.items()})
    return out


def phase_run_progress_samplers(dev) -> dict:
    """``run_progress`` against a twin's ``run()`` from the same seed at
    each stage's chain count and a short K-aligned length: NUTS Gaussian2D
    (131,072 chains, Kernel 4), MH (65,536, Kernel 5), Gibbs (65,536,
    Kernel 6), separable (1,024 x D=10,000, Kernel 7) and tempering (8,192
    x 8 rungs, Kernel 8): the cubes equal bit for bit, the same launches,
    no plain twin. Returns each kernel's launches a drive."""
    nuts_target = mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV)
    gauss = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    stages = (
        ("nuts", "nuts_step", (256, 128), False, lambda: mt.NUTS(
            nuts_target, mt.init_with_seed(NUTS_CHAINS, 2, seed=7,
                                           device=dev),
            0.8, use_pallas="full").seed(7)),
        ("mh", "mh_multistep", (256, 256), True,
         lambda: mt.MetropolisHastings(
             gauss, mt.isotropic_gaussian_proposal(1.0),
             mt.init_with_seed(MH_CHAINS, 2, seed=8, device=dev),
             use_pallas="full", steps_per_call=MH_K).seed(8)),
        ("gibbs", "gibbs_multistep", (512, 512), True,
         lambda: mt.GibbsSampler(
             mt.gaussian_mixture_conditional(*MIX),
             torch.zeros((MH_CHAINS, 2), device=dev), use_pallas="full",
             steps_per_call=GIBBS_K).seed(42)),
        ("separable", "hmc_separable_step", (32, 32), True, lambda: mt.HMC(
            mt.standard_normal(),
            mt.init_with_seed(SEP_CHAINS, SEP_DIM, seed=2, device=dev),
            SEP_EPS, SEP_L, use_pallas="separable").seed(2)),
        ("pt", "pt_multistep", (256, 256), True,
         lambda: mt.ParallelTempering(
             pt_mixture(), torch.full((PT_CHAINS, 1), -8.0, device=dev),
             betas=mt.geometric_betas(PT_TEMPS, 0.01), proposal_std=1.0,
             steps_per_call=PT_K, use_pallas="full").seed(5)),
    )
    launches = {}
    for label, kernel, (n_collect, n_discard), tm, make in stages:
        cubes, counts, secs = {}, {}, {}
        for drive in ("run_progress", "run", "tracked"):
            sampler = make()
            reset_counts()
            if drive == "run":
                cube, secs[drive] = timed(lambda: sampler.run(
                    n_collect, n_discard, time_major=tm))
            elif drive == "tracked":
                if label == "nuts":  # its runner records the initial row
                    sampler.state = sampler._prepare_fn(
                        sampler.state, sampler._next_key(), n_discard)
                cube, secs[drive] = timed(lambda: tracked_run(
                    sampler, n_collect, n_discard, tm))
            else:
                (cube, _), secs[drive] = timed(lambda: sampler.run_progress(
                    n_collect, n_discard, time_major=tm,
                    stream=io.StringIO()))
            counts[drive] = read_counts()
            cubes[drive] = cube
            del sampler, cube
        n = counts["run"][kernel]
        check(f"{label} run_progress launches and no plain twin",
              n > 0 and counts["run"] == counts["run_progress"]
              == counts["tracked"] == counts_with(**{kernel: n}), counts)
        equal = torch.equal(cubes["run_progress"], cubes["run"])
        check(f"{label} run_progress cube equals run()'s", equal, label)
        check(f"{label} tracked cube equals run()'s",
              torch.equal(cubes["tracked"], cubes["run"]), label)
        _, secs["run_stats"] = timed(lambda: mt.run_stats(
            cubes["run"], time_major=tm))
        launches[label] = n
        say("run_progress_samplers", sampler=label, kernel=kernel,
            run=f"({n_collect},{n_discard})", equal_to_run=equal,
            launches=n, run_launches=n, plain_twin_calls=0,
            **{f"{k}_s": repr(v) for k, v in secs.items()})
        del cubes
        torch.cuda.empty_cache()
    return launches


def phase_nuts_constrained(dev):
    """The NUTS stage of bench.py:286-336 with x0 > 0 through the public
    entry point: ``NUTS(diffable_gaussian2d, tf.to_x(init), 0.8,
    use_pallas="full", transform=tf)``, an adaptation run and the timed
    run, the gates of :func:`nuts_gates` on the truncated Gaussian's exact
    moments, every draw's x0 > 0, and Kernel 4's transformed instance once
    a step (2 x 2,175)."""
    target = mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV)
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=2)  # x0 > 0
    init = tf.to_x(mt.init_with_seed(NUTS_CHAINS, 2, seed=7, device=dev))
    reset_counts()
    nuts = mt.NUTS(target, init, 0.8, use_pallas="full",
                   transform=tf).seed(7)
    adapt = nuts.run(NUTS_COLLECT, NUTS_DISCARD)
    torch.cuda.synchronize()
    del adapt
    t0 = time.perf_counter()
    sample = nuts.run(NUTS_COLLECT, NUTS_DISCARD)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    check("nuts_constrained launches: the transformed instance, no twin",
          counts == counts_with(nuts_step=2 * NUTS_STEPS,
                                nuts_step_transformed=2 * NUTS_STEPS),
          counts)
    check("nuts_constrained sample", tuple(sample.shape) == (
        NUTS_CHAINS, NUTS_COLLECT, 2) and bool(torch.isfinite(
            sample).all()), tuple(sample.shape))
    m = nuts_gates(sample, int(nuts.last_run_divergences.sum()),
                   label="nuts_constrained", want_mean=TRUNC_MEAN,
                   want_var=TRUNC_VAR, divergence_limit=int(
                       TRUNC_DIVERGENCE_RATE * NUTS_CHAINS * NUTS_STEPS))
    m["x0_min"] = float(sample[..., 0].min())
    check("nuts_constrained x0 > 0", m["x0_min"] > 0.0, m["x0_min"])
    del sample
    m["elapsed_s"] = elapsed
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = NUTS_STEPS * NUTS_CHAINS / elapsed
    m["step_us"] = elapsed / NUTS_STEPS * 1e6
    m["leapfrogs_per_draw"] = float(
        nuts.last_run_leapfrogs.double().mean()) / NUTS_STEPS
    m["step_size_mean"] = float(nuts.step_size.mean())
    say("nuts_constrained", **{k: repr(v) for k, v in m.items()},
        want_mean=repr(TRUNC_MEAN), want_var=repr(TRUNC_VAR),
        launches_per_run=NUTS_STEPS, **counts)
    return nuts, m, counts


def phase_k1234_transformed(nuts, dev) -> dict:
    """The transformed instances of Kernels 1-4 (``csrc/targets.cuh:
    Transformed``) from the constrained stage's equilibrium: a short
    ``use_pallas=True`` NUTS run (Kernel 3, counted); ``HMC(transform=)``
    on K12_TRANSFORMED_CHAINS of its chains through the ``True`` and
    ``"full"`` tiers (Kernels 1 and 2, one K-step block each, counted);
    each instance against its twin as phases 5, 6, 10 and 11 hold the
    plain ones (Kernel 1 at L = 8 and 192, Kernel 2 at K = 16 and L = 8,
    Kernel 3 at j = 0..5, Kernel 4 for one step); Kernel 4's
    ``Whitened<Transformed<...>>`` instance from ``reconditioned("diag")``
    for one step; and the times of all of them (CUDA events) on all the
    stage's chains."""
    target, tf = nuts.target, nuts.transform
    reset_counts()
    tier = mt.NUTS(target, nuts.positions, 0.8, use_pallas=True,
                   transform=tf).seed(3)
    rows = tier.run(16, 0)
    torch.cuda.synchronize()
    tier_counts = read_counts()
    n3 = tier_counts["nuts_subtree"]
    check("transformed use_pallas=True NUTS launches", n3 > 0
          and tier_counts == counts_with(nuts_subtree=n3,
                                         nuts_subtree_transformed=n3),
          tier_counts)
    check("transformed use_pallas=True rows", bool(
        torch.isfinite(rows).all()) and bool((rows[..., 0] > 0).all()),
          "non-finite or x0 <= 0")
    x = nuts.positions[:K12_TRANSFORMED_CHAINS]
    runs = {}
    for use_pallas, kernel, launches in (
            (True, "leapfrog_trajectory", STEPS_PER_CALL),
            ("full", "hmc_multistep", 1)):
        reset_counts()
        h = mt.HMC(target, x, K12_TRANSFORMED_EPS, 8, use_pallas=use_pallas,
                   steps_per_call=STEPS_PER_CALL, transform=tf).seed(5)
        rows = h.run(STEPS_PER_CALL, 0, time_major=True)
        torch.cuda.synchronize()
        counts = read_counts()
        check(f"transformed {kernel} launches", counts == counts_with(**{
            kernel: launches, f"{kernel}_transformed": launches}), counts)
        check(f"transformed {kernel} rows natural", bool(
            (rows[..., 0] > 0).all()) and torch.equal(rows[-1],
                                                      h.positions),
              tuple(rows.shape))
        runs[kernel] = counts[kernel]
    lf = phase_leapfrog(h.kernel_target, h.state, dev, K12_TRANSFORMED_EPS,
                        label="leapfrog_transformed")
    ms_err = phase_multistep(h.kernel_target, h.state, dev,
                             K12_TRANSFORMED_EPS,
                             label="multistep_transformed")
    sub_err, sub_leaves = 0.0, {}
    for j in range(6):
        e, done, _ = subtree_case(nuts, dev, j, seed=140 + j,
                                  label="subtree_transformed")
        sub_err, sub_leaves[j] = max(sub_err, e), done
    step_err, step_details, step_args = phase_nuts_step(
        nuts, dev, label="nuts_step_transformed")
    # Whitened<Transformed<...>>: a diag metric of the unconstrained
    # ensemble, its step size found and adapted by a short run (counted)
    reset_counts()
    white = nuts.reconditioned("diag", seed=11)
    white.run(64, 64)
    torch.cuda.synchronize()
    w_counts = read_counts()
    check("whitened-transformed launches", w_counts == counts_with(
        nuts_step=127, nuts_step_transformed=127), w_counts)
    check("whitened over transformed", white.kernel_target.cuda_affine
          and white.kernel_target.cuda_transform is not None,
          white.kernel_target)
    wt_err, wt_details, wt_args = phase_nuts_step(
        white, dev, label="nuts_step_whitened_transformed")
    # the times, on all the stage's chains (y-space state)
    s = nuts.state
    y = s.positions
    kt = nuts.kernel_target
    logp, grad = kt.batch_logp_and_grad(y)
    gen = torch.Generator(device=dev).manual_seed(17)
    mom = torch.randn(y.shape, generator=gen, device=dev)
    eps1 = torch.tensor([K12_TRANSFORMED_EPS], device=dev)
    eps_k = torch.full((STEPS_PER_CALL,), K12_TRANSFORMED_EPS, device=dev)
    hist = torch.empty((STEPS_PER_CALL,) + tuple(y.shape), device=dev)
    sub_args = subtree_inputs(nuts, dev, 4, seed=144)
    out = {
        "leapfrog_err": lf[8][0], "multistep_err": ms_err,
        "subtree_err": sub_err, "nuts_step_err": step_err,
        "nuts_step_whitened_err": wt_err,
        "leapfrog_launches": runs["leapfrog_trajectory"],
        "multistep_launches": runs["hmc_multistep"],
        "subtree_launches": n3, "whitened_launches": w_counts["nuts_step"],
        "leapfrog_ms": cuda_ms(lambda: leapfrog_trajectory(
            kt, y, mom, grad, eps1, N_LEAPFROG), 20),
        "leapfrog_plain_ms": cuda_ms(lambda: leapfrog_trajectory_plain(
            kt, y, mom, grad, eps1[0], N_LEAPFROG), 2),
        "multistep_ms": cuda_ms(lambda: hmc_multistep(
            kt, y, logp, grad, eps_k, 8, 1, 0, hist), 20),
        "multistep_plain_ms": cuda_ms(lambda: hmc_multistep_plain(
            kt, y, logp, grad, eps_k, 8, 1, 0, hist), 2),
        "subtree_ms": cuda_ms(lambda: subtree(*sub_args), 20),
        "subtree_plain_ms": cuda_ms(lambda: subtree_plain(*sub_args), 2),
        "nuts_step_ms": cuda_ms(lambda: nuts_step(*step_args), 20),
        "nuts_step_plain_ms": cuda_ms(lambda: nuts_step_plain(*step_args),
                                      2),
        "nuts_step_whitened_ms": cuda_ms(lambda: nuts_step(*wt_args), 20),
        "nuts_step_whitened_plain_ms": cuda_ms(
            lambda: nuts_step_plain(*wt_args), 2),
    }
    say("k1234_transformed", shape=f"C={NUTS_CHAINS},D=2,L={N_LEAPFROG} "
        f"(Kernel 1),K={STEPS_PER_CALL},L=8 (Kernel 2),subtree_j=4",
        chains_checked_k12=K12_TRANSFORMED_CHAINS,
        **{k: repr(v) for k, v in out.items()})
    return dict(out, details=step_details, whitened_details=wt_details,
                subtree_leaves=sub_leaves)


def phase_funnel_kernels(dev) -> dict:
    """``neal_funnel(3.0)`` at D = 4 (the ``NealFunnel`` functor of
    Kernels 1-4) on FUNNEL_CHAINS chains started at 0.1 * init_with_seed:
    Kernel 4 for one step and Kernel 3 at j = 0..3 against their twins
    from the start at a step of 0.2; then ``NUTS(use_pallas="full")``
    ``run(256, 256)``, whose draws must all be finite, its divergences
    printed (the funnel's neck biases NUTS by design: no moment gate);
    the times of Kernels 4 and 3 (CUDA events)."""
    from types import SimpleNamespace

    target = mt.neal_funnel(FUNNEL_SCALE)
    init = 0.1 * mt.init_with_seed(FUNNEL_CHAINS, FUNNEL_DIM, seed=5,
                                   device=dev)
    start = SimpleNamespace(
        kernel_target=target, state=SimpleNamespace(positions=init),
        step_size=torch.full((FUNNEL_CHAINS,), 0.2, device=dev))
    err, details, step_args = phase_nuts_step(start, dev,
                                              label="nuts_step_funnel")
    sub_err, sub_leaves = 0.0, {}
    for j in range(4):
        e, done, _ = subtree_case(start, dev, j, seed=160 + j,
                                  label="subtree_funnel")
        sub_err, sub_leaves[j] = max(sub_err, e), done
    reset_counts()
    nuts = mt.NUTS(target, init, 0.8, use_pallas="full").seed(5)
    t0 = time.perf_counter()
    sample = nuts.run(FUNNEL_RUN, FUNNEL_RUN)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    steps = 2 * FUNNEL_RUN - 1
    check("funnel launches and no twin", counts == counts_with(
        nuts_step=steps), counts)
    check("funnel draws finite", tuple(sample.shape) == (
        FUNNEL_CHAINS, FUNNEL_RUN, FUNNEL_DIM) and bool(
            torch.isfinite(sample).all()), tuple(sample.shape))
    sub_args = subtree_inputs(start, dev, 3, seed=163)
    out = {
        "err": err, "subtree_err": sub_err, "launches": counts["nuts_step"],
        "elapsed_s": elapsed,
        "divergences": int(nuts.divergences.sum()),
        "divergences_last_half": int(nuts.last_run_divergences.sum()),
        "v_mean": float(sample[..., 0].mean()),
        "v_var": float(sample[..., 0].var()),
        "leapfrogs_per_draw": float(
            nuts.last_run_leapfrogs.double().mean()) / steps,
        "ms": cuda_ms(lambda: nuts_step(*step_args), 20),
        "plain_ms": cuda_ms(lambda: nuts_step_plain(*step_args), 2),
        "subtree_ms": cuda_ms(lambda: subtree(*sub_args), 20),
        "subtree_plain_ms": cuda_ms(lambda: subtree_plain(*sub_args), 2),
    }
    say("funnel_kernels", scale=FUNNEL_SCALE, D=FUNNEL_DIM,
        chains=FUNNEL_CHAINS, **{k: repr(v) for k, v in out.items()},
        **counts)
    return dict(out, details=details, subtree_leaves=sub_leaves)


def sep_mixed_case(dev):
    """The separable shape's standard normal under a mixed table, five
    blocks of D (identity, positive, lower_bounded(-1), upper_bounded(2),
    interval(0, 1)), from natural states drawn from the normal and folded
    into each block's range; returns (wrapped target, y, logp)."""
    kinds = [mt.identity(), mt.positive(), mt.lower_bounded(-1.0),
             mt.upper_bounded(2.0), mt.interval(0.0, 1.0)]
    tf = mt.CoordinateTransform(
        {i: kinds[i * 5 // SEP_DIM] for i in range(SEP_DIM)}, dim=SEP_DIM)
    gen = torch.Generator(device=dev).manual_seed(909)
    x = torch.randn((SEP_CHAINS, SEP_DIM), generator=gen, device=dev)
    block = torch.arange(SEP_DIM, device=dev) * 5 // SEP_DIM
    x = torch.where(block == 1, x.abs(), x)
    x = torch.where(block == 2, -1.0 + (x + 1.0).abs(), x)
    x = torch.where(block == 3, 2.0 - (2.0 - x).abs(), x)
    x = torch.where(block == 4, x.abs().clamp(0.01, 0.99), x)
    w = tf.wrap(mt.standard_normal())
    y = tf.to_y(x).contiguous()
    check("sep mixed states finite", bool(torch.isfinite(y).all()), "y")
    return w, y, w.batch_logp(y).float()


def phase_sep_constrained(dev):
    """The separable stage's shape constrained
    (examples/bigd_separable_hmc.py:41-46): ``standard_normal()`` with
    ``positive()`` on all D = 10,000 coordinates, 1,024 chains starting at
    x = 1, ``HMC(..., SEP_C_EPS, SEP_C_L, use_pallas="separable",
    transform=tf).seed(1)`` (eps 0.04, L = 40: the example's 0.22 and 8
    accept nothing at this D), ``run(128, 128, time_major=True)`` twice,
    and the plain
    tier the same way: the gates of bench.py:635-640 on the half-normal
    (mean within 0.02 of sqrt(2 / pi), variance within 0.05 of 1 - 2 / pi,
    every draw > 0, R-hat on the [128, 1024, 1024] sub-cube, the ESS floor
    of 0.5% of C n), a speedup over the plain tier of at least 0.9, and
    Kernel 7's transformed fused step 256 times a run. Then the row map
    ``to_x`` of one [1024, 10000] row (CUDA events), and one step against
    the twins twice (:func:`sep_kernel_check`, :func:`sep_step_check`): on
    the mixed table of :func:`sep_mixed_case` and under a diagonal metric
    estimated from the equilibrium (the scaled transformed instance);
    their times."""
    tf = mt.CoordinateTransform({i: mt.positive() for i in range(SEP_DIM)},
                                dim=SEP_DIM)
    out, counts = {}, None
    for tier in ("separable", False):
        reset_counts()
        init = torch.ones((SEP_CHAINS, SEP_DIM), device=dev)
        h = mt.HMC(mt.standard_normal(), init, SEP_C_EPS, SEP_C_L,
                   use_pallas=tier, transform=tf).seed(1)
        sample, elapsed = timed_run(h, SEP_COLLECT, SEP_COLLECT,
                                    time_major=True)
        c = read_counts()
        steps = 2 * SEP_COLLECT
        label = "separable" if tier else "plain"
        if tier:
            counts, sep = c, h
            check("sep_constrained launches: the transformed fused step, "
                  "no two-pass launch, no twin", c == counts_with(
                      hmc_separable_step=2 * steps,
                      hmc_separable_step_transformed=2 * steps), c)
        else:
            check("sep_constrained plain tier launches no kernel",
                  not any(c[k] for k in KERNELS), c)
        check(f"sep_constrained {label} sample", tuple(sample.shape) == (
            SEP_COLLECT, SEP_CHAINS, SEP_DIM) and bool(
                torch.isfinite(sample).all()), tuple(sample.shape))
        var, mean = torch.var_mean(sample, correction=0)
        rhat, ess = mt.split_rhat_mean_ess(
            sample[:, :, :SEP_DIAG_DIM].contiguous(), time_major=True)
        m = {
            "elapsed_s": elapsed, "mean": float(mean), "var": float(var),
            "min": float(sample.min()),
            "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
            "accept_rate": float((sample[1:, :, 0] != sample[:-1, :, 0])
                                 .float().mean()),
            "draws_per_sec": steps * SEP_CHAINS / elapsed,
            "coordinate_updates_per_sec":
                steps * SEP_CHAINS * SEP_DIM / elapsed,
            "step_us": elapsed / steps * 1e6,
        }
        m["ess_per_sec"] = m["ess_mean"] / elapsed
        del sample, rhat, ess
        if not tier:
            del h
        torch.cuda.empty_cache()
        check(f"sep_constrained {label} mean",
              abs(m["mean"] - SEP_C_MEAN) < 0.02, m["mean"])
        check(f"sep_constrained {label} var",
              abs(m["var"] - SEP_C_VAR) < 0.05, m["var"])
        check(f"sep_constrained {label} min > 0", m["min"] > 0.0, m["min"])
        check(f"sep_constrained {label} rhat",
              0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
        check(f"sep_constrained {label} ess floor",
              m["ess_mean"] >= 0.005 * SEP_CHAINS * SEP_COLLECT,
              (m["ess_mean"], SEP_CHAINS * SEP_COLLECT))
        out[label] = m
    speedup = out["plain"]["elapsed_s"] / out["separable"]["elapsed_s"]
    out["separable"]["speedup_vs_plain"] = speedup
    check("sep_constrained speedup over the plain tier", speedup >= 0.9,
          speedup)
    # a recorded row's map back to natural coordinates: one [C, D] pass
    row = sep.state.positions
    out["separable"]["row_to_x_ms"] = cuda_ms(lambda: tf.to_x(row), 20)
    for label, m in out.items():
        say(f"sep_constrained_{label}", **{k: repr(v) for k, v in m.items()},
            **(dict(launches_per_run=2 * SEP_COLLECT, **counts)
               if label == "separable" else {}))
    # one step against the twins: the mixed table, then a diag metric
    w, y, logp = sep_mixed_case(dev)
    sep_kernel_check(w, y, 0.1, "sep_mixed_kernel")
    err, args = sep_step_check(w, y, logp, 0.1, "sep_mixed_step")
    traj = (w, y) + args[3:]
    t = {"err": err,
         "ms": cuda_ms(lambda: hmc_separable_step(*args), 20),
         "plain_ms": cuda_ms(lambda: hmc_separable_step_plain(*args), 3),
         "ms_trajectory_only": cuda_ms(lambda: hmc_separable(*traj), 20)}
    white = sep.reconditioned("diag")
    check("sep_constrained scaled transformed instance",
          white.kernel_target.cuda_scaled
          and white.kernel_target.cuda_transform is not None,
          white.kernel_target)
    wt, wy = white.kernel_target, white.state.positions
    sep_kernel_check(wt, wy, white.step_size, "sep_scaled_transformed_kernel")
    t["scaled_err"], wargs = sep_step_check(
        wt, wy, white.state.logp, white.step_size,
        "sep_scaled_transformed_step")
    wtraj = (wt, wy) + wargs[3:]
    t["scaled_ms"] = cuda_ms(lambda: hmc_separable_step(*wargs), 20)
    t["scaled_plain_ms"] = cuda_ms(
        lambda: hmc_separable_step_plain(*wargs), 3)
    t["scaled_ms_trajectory_only"] = cuda_ms(
        lambda: hmc_separable(*wtraj), 20)
    # the all-positive stage's own step
    pargs = (sep.kernel_target, sep.state.positions, sep.state.logp,
             torch.tensor([SEP_C_EPS], device=dev), SEP_C_L, 0x5EED_C0, 3,
             sep_tables(sep.kernel_target, sep.state.positions))
    t["positive_ms"] = cuda_ms(lambda: hmc_separable_step(*pargs), 20)
    t["positive_plain_ms"] = cuda_ms(
        lambda: hmc_separable_step_plain(*pargs), 3)
    say("sep_constrained_times", shape=f"C={SEP_CHAINS},D={SEP_DIM},"
        f"L={SEP_L} (mixed, scaled),L={SEP_C_L} (positive)",
        **{k: repr(v) for k, v in t.items()})
    return sep, counts, out, t


def phase_eight_schools(dev) -> dict:
    """Eight schools' NUTS half (bench.py:1259-1341) on the port's lockstep
    tier (``use_pallas=False``), which runs no hand-written kernel:
    ``make_noncentered_target()``, 4,096 chains, D = 10, ``NUTS(target,
    init_with_seed(4096, 10, seed=31), 0.9, seed=31).warmed_up(100,
    "diag")`` (ES8_LOCKSTEP_ADAPT), then ``run(64, 64)`` (the step size
    adapted in the whitened space, ES8_FIRST_COLLECT) and the timed
    ``run(128, 64)`` (ES8_NUTS_COLLECT, ES8_LOCKSTEP_DISCARD);
    :func:`es8_gates`, leapfrogs per draw, ESS/s and the time."""
    from mini_mcmc_torch.examples.eight_schools import (
        make_noncentered_target,
    )

    c8, n8, nd8 = ES8_CHAINS, ES8_NUTS_COLLECT, ES8_LOCKSTEP_DISCARD
    reset_counts()
    t0 = time.perf_counter()
    warm = mt.NUTS(make_noncentered_target(), mt.init_with_seed(
        c8, 10, seed=31, device=dev), 0.9, seed=31).warmed_up(
            ES8_LOCKSTEP_ADAPT, "diag")
    first = warm.run(ES8_FIRST_COLLECT, nd8)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del first
    t0 = time.perf_counter()
    sample = warm.run(n8, nd8)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    check_no_kernel("eight_schools")
    m = es8_gates("eight_schools", sample, warm, elapsed, n8 + nd8 - 1)
    m["warm_up_and_first_run_s"] = warm_s
    say("eight_schools", kernels="none (the lockstep tier)",
        **{k: repr(v) for k, v in m.items()})
    return m


def es8_gates(label: str, sample, nuts, elapsed: float, steps: int) -> dict:
    """The gates of bench.py:1285-1317 on a timed eight-schools NUTS run
    (|E[mu] - exact| <= 0.25, |E[exp(log_tau)] - exact| <= 0.4, R-hat
    mean in [0.95, 1.05], ESS min >= 0.002 C n, steady-state divergence
    rate <= 2e-3) and its measures: leapfrogs per draw, ESS/s, draws/s, µs
    a step."""
    from mini_mcmc_torch.examples.eight_schools import exact_posterior_means

    exact_mu, exact_tau = exact_posterior_means()
    c8, n8 = sample.shape[:2]
    div = int(nuts.last_run_divergences.sum())
    rhat, ess = mt.split_rhat_mean_ess(sample)
    m = {
        "exact_mu": exact_mu, "exact_tau": exact_tau,
        "mu_hat": float(sample[..., 0].double().mean()),
        "tau_hat": float(sample[..., 1].double().exp().mean()),
        "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
        "ess_min": float(ess.min()),
        "divergence_rate": div / (c8 * steps),
        "leapfrogs_per_draw": float(
            nuts.last_run_leapfrogs.double().mean()) / steps,
        "elapsed_s": elapsed, "us_per_step": elapsed / steps * 1e6,
        "draws_per_sec": c8 * steps / elapsed,
    }
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    check(f"{label} E[mu]", abs(m["mu_hat"] - exact_mu) <= 0.25,
          (m["mu_hat"], exact_mu))
    check(f"{label} E[tau]", abs(m["tau_hat"] - exact_tau) <= 0.4,
          (m["tau_hat"], exact_tau))
    check(f"{label} rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    check(f"{label} ess floor", m["ess_min"] >= 0.002 * c8 * n8,
          (m["ess_min"], c8 * n8))
    check(f"{label} steady-state divergence rate",
          m["divergence_rate"] <= 2e-3, m["divergence_rate"])
    return m


def phase_mh_constrained(dev):
    """The MH stage of bench.py:391-431 with x0 > 0 through the public
    entry point: ``MetropolisHastings(gaussian2d, walk 1.0, tf.to_x(init),
    use_pallas="full", steps_per_call=16, transform=tf)``, warm-up and
    timed run, the gates (x0's half-normal moments, x1 ~ N(0, 1), R-hat,
    the stage's ESS floor, every draw's x0 > 0), Kernel 5's transformed
    instance 128 times a run; then that instance against its twin, the
    times, and the recorded rows' map ``to_x`` on a [65536, 2] row."""
    target = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=2)
    init = tf.to_x(mt.init_with_seed(MH_CHAINS, 2, seed=8, device=dev))
    reset_counts()
    mh = mt.MetropolisHastings(target, mt.isotropic_gaussian_proposal(1.0),
                               init, use_pallas="full", steps_per_call=MH_K,
                               transform=tf).seed(8)
    sample, elapsed = timed_run(mh, MH_COLLECT, 0, time_major=True)
    counts = read_counts()
    per_run = MH_COLLECT // MH_K
    check("mh_constrained launches: the transformed instance, no twin",
          counts == counts_with(mh_multistep=2 * per_run,
                                mh_multistep_transformed=2 * per_run),
          counts)
    check("mh_constrained sample", tuple(sample.shape) == (
        MH_COLLECT, MH_CHAINS, 2) and bool(torch.isfinite(sample).all()),
        tuple(sample.shape))
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    flat = sample.reshape(-1, 2).double()
    total = MH_CHAINS * MH_COLLECT
    m = {"elapsed_s": elapsed, "rhat_mean": float(rhat.mean()),
         "ess_mean": float(ess.mean()),
         "mean": [float(v) for v in flat.mean(0)],
         "var": [float(v) for v in flat.var(0, unbiased=False)],
         "x0_min": float(flat[:, 0].min()),
         "accept_rate": float((sample[1:] != sample[:-1]).any(2)
                              .float().mean())}
    del sample, flat
    check("mh_constrained x0 > 0", m["x0_min"] > 0.0, m["x0_min"])
    check("mh_constrained rhat", 0.95 <= m["rhat_mean"] <= 1.05,
          m["rhat_mean"])
    check("mh_constrained x0 mean (half-normal)",
          abs(m["mean"][0] - HALF_NORMAL_MEAN) <= 0.03, m["mean"])
    check("mh_constrained x0 var (half-normal)",
          abs(m["var"][0] - HALF_NORMAL_VAR) <= 0.05, m["var"])
    check("mh_constrained x1 mean", abs(m["mean"][1]) <= 0.03, m["mean"])
    check("mh_constrained x1 var", abs(m["var"][1] - 1.0) <= 0.05, m["var"])
    check("mh_constrained ess floor", m["ess_mean"] >= 0.02 * total,
          (m["ess_mean"], total))
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = total / elapsed
    m["block_us"] = elapsed / per_run * 1e6
    row = mh.state.positions
    m["row_to_x_ms"] = cuda_ms(lambda: tf.to_x(row), 50)
    say("mh_constrained", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    k5 = phase_mh_kernel(mh, "gauss2d_transformed", MH_K, 0x5EED_0A0A)
    say("mh_constrained_times", shape=f"C={MH_CHAINS},gauss2d K={MH_K}",
        **{k: repr(v) for k, v in k5.items() if k != "err"})
    return counts, k5, mh


def phase_pt_constrained(dev):
    """The tempering stage of bench.py:858-909 with ``interval(-24, 24)``
    through the public entry point (cold scale PT_C_STD in y): warm-up and
    timed run, the four gates of bench.py:890-898 and every draw inside
    the interval, Kernel 8's transformed instance 128 times a run; then
    that instance against its twin and the times."""
    tf = mt.CoordinateTransform({0: mt.interval(-24.0, 24.0)}, dim=1)
    reset_counts()
    pt = mt.ParallelTempering(
        pt_mixture(), torch.full((PT_CHAINS, 1), -8.0, device=dev),
        betas=mt.geometric_betas(PT_TEMPS, 0.01), proposal_std=PT_C_STD,
        steps_per_call=PT_K, use_pallas="full", transform=tf).seed(5)
    sample, elapsed = timed_run(pt, PT_COLLECT, 0, time_major=True)
    counts = read_counts()
    per_run = PT_COLLECT // PT_K
    check("pt_constrained launches: the transformed instance, no twin",
          counts == counts_with(pt_multistep=2 * per_run,
                                pt_multistep_transformed=2 * per_run),
          counts)
    xs = sample.reshape(-1)
    plus = xs[xs > 0].double()
    swap = pt.swap_acceptance
    m = {"elapsed_s": elapsed, "mode_weight": float((xs > 0).float().mean()),
         "plus_mean": float(plus.mean()),
         "plus_std": float(plus.std(unbiased=False)),
         "range": [float(xs.min()), float(xs.max())],
         "swap_acceptance": [float(v) for v in swap],
         "cold_draws_per_sec": PT_CHAINS * PT_COLLECT / elapsed,
         "replica_updates_per_sec":
             PT_CHAINS * PT_TEMPS * PT_COLLECT / elapsed,
         "block_us": elapsed / per_run * 1e6}
    del sample, xs, plus
    check("pt_constrained inside (-24, 24)",
          -24.0 < m["range"][0] and m["range"][1] < 24.0, m["range"])
    check("pt_constrained mode weight",
          abs(m["mode_weight"] - PT_W_PLUS) <= 0.05, m["mode_weight"])
    check("pt_constrained mode mean", abs(m["plus_mean"] - 8.0) <= 0.05,
          m["plus_mean"])
    check("pt_constrained mode std", abs(m["plus_std"] - 0.5) <= 0.05,
          m["plus_std"])
    check("pt_constrained swap rates alive", bool((swap > 0.05).all()),
          m["swap_acceptance"])
    say("pt_constrained", **{k: repr(v) for k, v in m.items()},
        launches_per_run=per_run, **counts)
    k8 = phase_pt_kernel(pt, 0x5EED_8A8A, PT_C_STD, "pt_kernel_transformed")
    say("pt_constrained_times", shape=f"C={PT_CHAINS},T={PT_TEMPS},K={PT_K},"
        "D=1", **{k: repr(v) for k, v in k8.items() if k != "err"})
    return counts, k8


def moment_metrics(sample, elapsed: float) -> dict:
    """A time-major cube's split R-hat and ESS (mean and min), per
    coordinate mean and population variance, ESS/s and draws/s."""
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    flat = sample.reshape(-1, sample.shape[2]).double()
    n = flat.shape[0]
    return {"elapsed_s": elapsed, "rhat_mean": float(rhat.mean()),
            "ess_mean": float(ess.mean()), "ess_min": float(ess.min()),
            "mean": [float(v) for v in flat.mean(0)],
            "var": [float(v) for v in flat.var(0, unbiased=False)],
            "ess_per_sec": float(ess.mean()) / elapsed,
            "draws_per_sec": n / elapsed}


def idle_share(fn) -> dict:
    """The device's idle share over one profiled call of ``fn`` (the
    profiler's own overhead included in the wall time), and the device
    operations (kernels, copies, fills) it recorded, in all and those
    whose name is a matrix product's (``gemm``)."""
    wall, busy, by_name = device_profile(fn)
    return {"profiled_wall_s": wall, "device_busy_us": busy,
            "idle_share": 1.0 - busy / (wall * 1e6),
            "kernels_by_name": len(by_name),
            "device_ops": sum(n for n, _ in by_name.values()),
            "gemm_ops": sum(n for k, (n, _) in by_name.items()
                            if "gemm" in k.lower())}


def host_syncs(fn):
    """``fn()`` and the times it synchronized the host with the device
    (a device-to-host read or a wait): CUDA's sync debug mode warns once a
    synchronizing call (a prototype that PyTorch says may miss some)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def timed_best(fn, reps: int = TIMED_REPS):
    """bench.py:_timed_best: ``reps`` calls of ``fn`` (completion
    included), each result freed before the next; returns (the last
    result, the fastest call's seconds, every call's seconds)."""
    times, out = [], None
    for _ in range(reps):
        out = None
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, min(times), times


def check_no_kernel(label: str) -> None:
    counts = read_counts()
    check(f"{label} runs no kernel", not any(counts[k] for k in KERNELS),
          counts)


def evidence_target(dev):
    """bench.py:1008-1019: the unnormalized correlated Gaussian2D on
    ``dev`` and its analytic log Z."""
    cov = torch.tensor(NUTS_COV, dtype=torch.float64)
    prec = torch.linalg.inv(cov).float().to(dev)
    true_log_z = 0.5 * (2 * math.log(2 * math.pi)
                        + math.log(float(torch.linalg.det(cov))))

    def logp(xs):
        return -0.5 * torch.einsum("ni,ij,nj->n", xs, prec, xs)

    return mt.models.Target(logp=logp), true_log_z


def phase_ais(dev) -> dict:
    """bench.py:1003-1043: ``ais_log_z`` at 65,536 particles, 64 rungs x 2
    MH steps (the gates: log Z within 0.05 of the analytic value, weight
    ESS above 0.3), then ``make_anneal`` on bench.py's float64 linspace
    schedule timed best of 3 (particle updates/s, N x 64 x 3 / s), its
    device-to-host reads (none), device operations a rung and the idle
    share of a profiled anneal."""
    import numpy as np

    target, true_log_z = evidence_target(dev)
    reset_counts()
    t0 = time.perf_counter()
    r = mt.ais_log_z(target, EV_PARTICLES, 2, betas=AIS_RUNGS, seed=0,
                     device=dev, **AIS_KW)
    log_z, ess = float(r.log_z), float(r.weight_ess)
    first_s = time.perf_counter() - t0
    del r
    anneal = mt.ops.make_anneal(target, tuple(
        float(b) for b in np.linspace(0.0, 1.0, AIS_RUNGS + 1)[1:]),
        **AIS_KW)
    x0 = 2.5 * torch.randn((EV_PARTICLES, 2), device=dev,
                           generator=torch.Generator(dev).manual_seed(2))

    def once():
        return anneal(x0, torch.Generator(dev).manual_seed(3))

    once()
    torch.cuda.synchronize()
    _, reads = host_syncs(once)
    torch.cuda.synchronize()
    _, elapsed, times = timed_best(once)
    check_no_kernel("ais")
    check("ais log_z", abs(log_z - true_log_z) < 0.05, (log_z, true_log_z))
    check("ais weight ess", ess > 0.3, ess)
    check("ais reads nothing from the device", reads == 0, reads)
    m = {"elapsed_s": elapsed, "times_s": times, "ais_log_z_s": first_s,
         "particle_updates_per_sec": EV_PARTICLES * AIS_RUNGS
         * (1 + AIS_KW["n_mh_steps"]) / elapsed,
         "log_z": log_z, "log_z_true": true_log_z, "weight_ess": ess,
         "device_to_host_reads": reads}
    m.update(idle_share(once))
    m["device_ops_per_rung"] = m["device_ops"] / AIS_RUNGS
    say("ais", **{k: repr(v) for k, v in m.items()})
    return m


def phase_smc(dev) -> dict:
    """bench.py:1045-1076: ``make_smc_run`` (target ESS 0.8, 5 MH sweeps a
    stage) built once, its first and second calls timed (the gates on the
    second: the anneal completes, log Z within 0.05), stages, the
    device-to-host reads a stage (the run's count and the sync debug
    mode's), device operations a stage and the idle share of a profiled
    third call."""
    target, true_log_z = evidence_target(dev)
    run = mt.ops.make_smc_run(target, **SMC_KW)
    x0 = 2.5 * torch.randn((EV_PARTICLES, 2), device=dev,
                           generator=torch.Generator(dev).manual_seed(4))
    reset_counts()
    t0 = time.perf_counter()
    run(x0, torch.Generator(dev).manual_seed(5))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reads0 = run.host_reads
    t0 = time.perf_counter()
    (_, beta, log_z, n_stages, _, _), syncs = host_syncs(
        lambda: run(x0, torch.Generator(dev).manual_seed(6)))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    check_no_kernel("smc")
    beta, log_z = float(beta), float(log_z)
    check("smc completed", beta == 1.0, beta)
    check("smc log_z", abs(log_z - true_log_z) < 0.05, (log_z, true_log_z))
    m = {"elapsed_s": elapsed, "first_call_s": first_s,
         "n_stages": n_stages, "log_z": log_z, "log_z_true": true_log_z,
         "reads_per_stage": (run.host_reads - reads0) / n_stages,
         "syncs_per_stage": syncs / n_stages}
    m.update(idle_share(lambda: run(x0, torch.Generator(dev).manual_seed(
        6))))
    m["device_ops_per_stage"] = m["device_ops"] / n_stages
    say("smc", **{k: repr(v) for k, v in m.items()})
    return m


def sg_regression(dev):
    """bench.py:1085-1110: the conjugate Bayesian linear regression's rows
    (numpy, seed 0), its analytic posterior (float64) and the minibatch
    estimator over its rows on ``dev``."""
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.standard_normal((SG_ROWS, SG_DIM)).astype(np.float32)
    x /= np.sqrt(SG_DIM)
    w_true = np.linspace(-1.0, 1.0, SG_DIM).astype(np.float32)
    y = (x @ w_true
         + SG_NOISE * rng.standard_normal(SG_ROWS)).astype(np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    prec = x64.T @ x64 / SG_NOISE**2 + np.eye(SG_DIM) / SG_TAU**2
    post_cov = np.linalg.inv(prec)
    post_mean = post_cov @ (x64.T @ y64) / SG_NOISE**2
    grad_fn = mt.minibatch_grad(
        lambda w: -0.5 * torch.sum(w * w) / SG_TAU**2,
        lambda w, batch: -0.5 * torch.sum(
            (batch[1] - batch[0] @ w) ** 2) / SG_NOISE**2,
        (x, y), batch_size=SG_BATCH, device=dev)
    return grad_fn, post_mean, np.diag(post_cov)


def sg_stage(label, sampler, n_burn, gates, rows_per_step=None) -> dict:
    """An SG-MCMC stage of bench.py: ``run(SG_STEPS, n_burn)``, then
    ``run(SG_STEPS)`` timed best of 3 (chains continuing), the gates on the
    last timed cube (time-major), draws/s (and minibatch rows/s), the
    device-to-host reads a step over a 128-step run (none expected), and
    a profiled 128-step run's idle share, device operations and matrix
    products a step."""
    reset_counts()
    warm = sampler.run(SG_STEPS, n_burn, time_major=True)
    torch.cuda.synchronize()
    del warm
    sample, elapsed, times = timed_best(
        lambda: sampler.run(SG_STEPS, 0, time_major=True))
    check_no_kernel(label)
    check(f"{label} sample finite", bool(torch.isfinite(sample).all()),
          "non-finite")
    flat = sample.reshape(-1, sample.shape[2]).double()
    mean, var = flat.mean(0).cpu().numpy(), flat.var(0, unbiased=False
                                                      ).cpu().numpy()
    del sample, flat
    m = {"elapsed_s": elapsed, "times_s": times,
         "draws_per_sec": SG_CHAINS * SG_STEPS / elapsed}
    if rows_per_step:
        m["minibatch_rows_per_sec"] = rows_per_step * SG_STEPS / elapsed
    gates(m, mean, var)
    _, reads = host_syncs(lambda: sampler.run(LOCKSTEP_PROFILE, 0,
                                              time_major=True))
    check(f"{label} reads nothing from the device", reads == 0, reads)
    m["device_to_host_reads_per_step"] = reads / LOCKSTEP_PROFILE
    m.update(idle_share(lambda: sampler.run(LOCKSTEP_PROFILE, 0,
                                            time_major=True)))
    m["device_ops_per_step"] = m["device_ops"] / LOCKSTEP_PROFILE
    m["gemm_per_step"] = m["gemm_ops"] / LOCKSTEP_PROFILE
    say(label, **{k: repr(v) for k, v in m.items()})
    torch.cuda.empty_cache()
    return m


def posterior_gates(label, post_mean, post_var, var_tol):
    """bench.py:1114-1119's gates: the largest posterior-mean error within
    1 posterior sd, the largest relative variance error within
    ``var_tol``."""
    import numpy as np

    def gates(m, mean, var):
        m["max_mean_err_posterior_sd"] = float(np.max(
            np.abs(mean - post_mean) / np.sqrt(post_var)))
        m["max_rel_var_err"] = float(np.max(np.abs(var / post_var - 1.0)))
        check(f"{label} posterior mean",
              m["max_mean_err_posterior_sd"] <= 1.0,
              m["max_mean_err_posterior_sd"])
        check(f"{label} posterior var", m["max_rel_var_err"] <= var_tol,
              m["max_rel_var_err"])

    return gates


def phase_sgld(grad_fn, post_mean, post_var, dev) -> dict:
    """bench.py:1078-1138: SGLD on the regression, 4,096 chains,
    ``polynomial_decay(2e-6, 50, 0.33)``, K = 16, ``run(2048, 2048)`` then
    the timed ``run(2048)``; the gates: mean within 1 sd, variance within
    30%."""
    sg = mt.SGLD(grad_fn, mt.init_with_seed(SG_CHAINS, SG_DIM, seed=21,
                                            device=dev),
                 step_size=mt.polynomial_decay(2e-6, 50.0, 0.33), seed=21,
                 steps_per_call=SG_K, device=dev)
    return sg_stage("sgld", sg, SG_STEPS,
                    posterior_gates("sgld", post_mean, post_var, 0.3),
                    rows_per_step=SG_BATCH)


def phase_psgld(dev) -> dict:
    """bench.py:1189-1224: pSGLD on N(0, diag(logspace(0, 2, 8))), 4,096
    chains, eps 0.02, ``rms_decay=0.9999``, K = 16, ``run(2048, 4096)``
    then the timed ``run(2048)``; the gates: each coordinate's variance
    within 30%, the scale-equalization ratio in (80, 140)."""
    import numpy as np

    sigma2 = torch.logspace(0.0, 2.0, PS_DIM, dtype=torch.float64)
    sigma2_dev = sigma2.float().to(dev)

    def aniso_grad(x, key):
        del key
        return -x / sigma2_dev[None, :]

    ps = mt.SGLD(aniso_grad, mt.init_with_seed(SG_CHAINS, PS_DIM, seed=27,
                                               device=dev),
                 step_size=0.02, seed=27, preconditioner="rmsprop",
                 rms_decay=0.9999, steps_per_call=SG_K, device=dev)

    def gates(m, _, var):
        rel = var / sigma2.numpy()
        m["max_rel_var_err"] = float(np.max(np.abs(rel - 1.0)))
        m["scale_equalization_ratio"] = float(var[-1] / var[0])
        check("psgld per-coordinate variance", m["max_rel_var_err"] <= 0.3,
              rel)
        check("psgld scale equalization",
              80.0 < m["scale_equalization_ratio"] < 140.0,
              m["scale_equalization_ratio"])

    return sg_stage("psgld", ps, 2 * SG_STEPS, gates)


def phase_sghmc(grad_fn, post_mean, post_var, dev) -> dict:
    """bench.py:1226-1257: SGHMC on the regression,
    ``polynomial_decay(1e-6, 50, 0.33)``, friction 0.5, 4,096 chains, K =
    16, ``run(2048, 2048)`` then the timed ``run(2048)``; the gates: mean
    within 1 sd, variance within 40%."""
    sh = mt.SGHMC(grad_fn, mt.init_with_seed(SG_CHAINS, SG_DIM, seed=29,
                                             device=dev),
                  step_size=mt.polynomial_decay(1e-6, 50.0, 0.33),
                  friction=0.5, seed=29, steps_per_call=SG_K, device=dev)
    return sg_stage("sghmc", sh, SG_STEPS,
                    posterior_gates("sghmc", post_mean, post_var, 0.4),
                    rows_per_step=SG_BATCH)


def lockstep_stage(label, sampler, n_collect, gates, profile_steps,
                   burn=None):
    """A burn-in run (``burn`` steps, ``n_collect`` by default as in
    bench.py) and the timed run of a lockstep sampler (no kernel),
    ``gates(metrics, sample)``, the launches (none) and the host's loop
    tests a step (``ops/slice.py:masked_loop``), then one profiled run
    of ``profile_steps`` steps for the idle share."""
    from mini_mcmc_torch.ops.slice import masked_loop

    reset_counts()
    warm = sampler.run(n_collect if burn is None else burn, 0,
                       time_major=True)
    torch.cuda.synchronize()
    del warm
    tests0 = masked_loop.host_tests
    t0 = time.perf_counter()
    sample = sampler.run(n_collect, 0, time_major=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    check_no_kernel(label)
    check(f"{label} sample finite", bool(torch.isfinite(sample).all()),
          "non-finite")
    m = moment_metrics(sample, elapsed)
    m["host_tests_per_step"] = (masked_loop.host_tests - tests0) / n_collect
    gates(m, sample)
    del sample
    m.update(idle_share(lambda: sampler.run(profile_steps, 0,
                                            time_major=True)))
    say(label, **{k: repr(v) for k, v in m.items()})
    torch.cuda.empty_cache()
    return m


def moment_gates(label, m, truth, mean_tol, var_tol):
    for d, (m_true, v_true) in enumerate(truth):
        check(f"{label} mean[{d}]", abs(m["mean"][d] - m_true) <= mean_tol,
              m["mean"])
        check(f"{label} var[{d}]", abs(m["var"][d] - v_true) <= var_tol,
              m["var"])


def phase_chees(dev) -> dict:
    """bench.py:777-820: ``ChEESHMC(diffable_gaussian2d([0, 1], [[4, 2],
    [2, 3]]), init_with_seed(65536, 2, seed=17), step_size=0.5).seed(17)
    .warmed_up(256)``, ``run(2048)`` after a burn-in run; the gates (the
    trajectory grew past twice the step, R-hat, the smallest ESS at least
    2% of the draws, the moments), ESS/s, draws/s, the warm-up's seconds
    and the idle share."""
    t0 = time.perf_counter()
    ch = mt.ChEESHMC(mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV),
                     mt.init_with_seed(CHEES_CHAINS, 2, seed=17, device=dev),
                     step_size=0.5).seed(17).warmed_up(CHEES_ADAPT)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    def gates(m, _):
        check("chees traj grew", ch.traj_len > 2.0 * ch.step_size,
              (ch.traj_len, ch.step_size))
        check("chees rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
        check("chees ess floor", m["ess_min"] >= 0.02 * CHEES_CHAINS
              * CHEES_COLLECT, m["ess_min"])
        moment_gates("chees", m, ((0.0, 4.0), (1.0, 3.0)), 0.05, 0.3)

    m = lockstep_stage("chees", ch, CHEES_COLLECT, gates, LOCKSTEP_PROFILE)
    m.update(eps_tuned=ch.step_size, traj_len_tuned=ch.traj_len,
             warm_up_s=warm_s,
             mean_leapfrogs_per_draw=ch.traj_len / (2.0 * ch.step_size))
    say("chees_adapted", **{k: repr(m[k]) for k in (
        "eps_tuned", "traj_len_tuned", "warm_up_s",
        "mean_leapfrogs_per_draw")})
    return m


def phase_ensemble(dev) -> dict:
    """bench.py:822-856: 1,024 ensembles x 64 walkers (65,536) on
    ``gaussian2d([0, 1], [[4, 2], [2, 3]])``, K = 16, ``run(2048)`` after a
    burn-in run; the gates (R-hat, ESS mean at least 0.1% of the draws,
    moments, the covariance), ESS/s, draws/s, the idle share."""
    es = mt.EnsembleSampler(
        mt.gaussian2d(NUTS_MEAN, NUTS_COV),
        mt.init_with_seed(ENS_CHAINS, 2, seed=3, device=dev),
        walkers_per_ensemble=ENS_WALKERS, steps_per_call=ENS_K).seed(3)

    def gates(m, sample):
        mean = sample.double().mean(dim=(0, 1))
        m["cov01"] = float(((sample[..., 0] - mean[0])
                            * (sample[..., 1] - mean[1])).double().mean())
        check("ensemble rhat", 0.95 <= m["rhat_mean"] <= 1.05,
              m["rhat_mean"])
        check("ensemble ess floor", m["ess_mean"] >= 1e-3 * ENS_CHAINS
              * ENS_COLLECT, m["ess_mean"])
        moment_gates("ensemble", m, ((0.0, 4.0), (1.0, 3.0)), 0.05, 0.2)
        check("ensemble cov01", abs(m["cov01"] - 2.0) <= 0.2, m["cov01"])

    return lockstep_stage("ensemble", es, ENS_COLLECT, gates,
                          LOCKSTEP_PROFILE)


def phase_slice(dev) -> dict:
    """bench.py:911-942: 65,536 chains on the ensemble stage's Gaussian,
    width 1, K = 16, ``run(2048)`` after a burn-in run of SLICE_BURN
    sweeps; the gates (R-hat, ESS mean at least 5% of the draws,
    moments), ESS/s, sweeps/s, the host's loop tests a sweep and the idle
    share."""
    sl = mt.SliceSampler(mt.gaussian2d(NUTS_MEAN, NUTS_COV),
                         mt.init_with_seed(SLICE_CHAINS, 2, seed=7,
                                           device=dev),
                         width=1.0, steps_per_call=SLICE_K).seed(7)

    def gates(m, _):
        check("slice rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
        check("slice ess floor", m["ess_mean"] >= 0.05 * SLICE_CHAINS
              * SLICE_COLLECT, m["ess_mean"])
        moment_gates("slice", m, ((0.0, 4.0), (1.0, 3.0)), 0.05, 0.2)

    return lockstep_stage("slice", sl, SLICE_COLLECT, gates, LOCKSTEP_PROFILE,
                          burn=SLICE_BURN)


def gp_posterior():
    """bench.py:952-975: the 64-point latent GP with a conjugate Gaussian
    likelihood: the float32 prior Cholesky the sampler uses, the
    likelihood's data, and the analytic posterior mean and covariance
    (float64, from that float32 factor)."""
    import numpy as np

    xs = np.linspace(-3.0, 3.0, GP_DIM)
    k_gp = np.exp(-0.5 * (xs[:, None] - xs[None, :]) ** 2 / 0.6**2)
    chol64 = np.linalg.cholesky(k_gp + 1e-4 * np.eye(GP_DIM))
    chol32 = chol64.astype(np.float32)
    k_eff = chol32.astype(np.float64) @ chol32.astype(np.float64).T
    rng_np = np.random.default_rng(0)
    f_true = chol64 @ rng_np.standard_normal(GP_DIM)
    y64 = f_true + GP_NOISE * rng_np.standard_normal(GP_DIM)
    a = k_eff + GP_NOISE**2 * np.eye(GP_DIM)
    post_mean = k_eff @ np.linalg.solve(a, y64)
    post_cov = k_eff - k_eff @ np.linalg.solve(a, k_eff)
    return chol32, y64.astype(np.float32), post_mean, post_cov


def phase_elliptical(dev) -> dict:
    """bench.py:944-1002: the 64-point latent GP posterior (conjugate, so
    the gates are analytic), 4,096 chains from 0, K = 16, ``run(2048)``
    after a burn-in run of GP_BURN steps, the prior draw a [4096, 64] @
    [64, 64] ``torch.matmul``; the gates (R-hat in [0.90, 1.05], the largest mean
    error at most 0.05, the largest relative variance error at most
    0.2), latent draws/s, the host's loop tests a step and the idle
    share."""
    import numpy as np

    chol32, y32, post_mean, post_cov = gp_posterior()
    y = torch.from_numpy(y32).to(dev)

    def loglik(f):
        return -0.5 * torch.sum(((y - f) / GP_NOISE) ** 2, dim=-1)

    el = mt.EllipticalSliceSampler(
        mt.models.Target(logp=loglik),
        torch.zeros((GP_CHAINS, GP_DIM), device=dev),
        prior_scale=torch.from_numpy(chol32), steps_per_call=GP_K).seed(9)

    def gates(m, _):
        mean, var = np.asarray(m["mean"]), np.asarray(m["var"])
        m["max_abs_mean_err"] = float(np.max(np.abs(mean - post_mean)))
        m["max_rel_var_err"] = float(np.max(np.abs(
            var / np.diag(post_cov) - 1.0)))
        m["latent_values_per_sec"] = m["draws_per_sec"] * GP_DIM
        del m["mean"], m["var"]
        check("elliptical rhat", 0.90 <= m["rhat_mean"] <= 1.05,
              m["rhat_mean"])
        check("elliptical posterior mean", m["max_abs_mean_err"] <= 0.05,
              m["max_abs_mean_err"])
        check("elliptical posterior var", m["max_rel_var_err"] <= 0.2,
              m["max_rel_var_err"])

    return lockstep_stage("elliptical", el, GP_COLLECT, gates,
                          LOCKSTEP_PROFILE, burn=GP_BURN)


def phase_eight_schools_chees(dev) -> dict:
    """Eight schools' ChEES half (bench.py:1342-1372): ``ChEESHMC(
    make_noncentered_target(), init_with_seed(4096, 10, seed=33),
    step_size=0.2, seed=33).warmed_up(500)``, ``run(1024, 256)`` twice
    (the second timed), the bench's moment gates, the adapted step size
    and trajectory length, leapfrogs a draw, gradient evaluations per
    effective sample, ESS/s."""
    from mini_mcmc_torch.examples import eight_schools as es8

    reset_counts()
    t0 = time.perf_counter()
    ch = es8.chees_adapted(device=dev, n_chains=ES8_CHAINS,
                           n_adapt=ES8_CHEES_ADAPT)
    first = ch.run(ES8_COLLECT, ES8_DISCARD)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del first
    t0 = time.perf_counter()
    sample = ch.run(ES8_COLLECT, ES8_DISCARD)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    check_no_kernel("eight_schools_chees")
    m = es8.moment_gates("eight_schools_chees", sample)
    del sample
    lf = ch.traj_len / (2.0 * ch.step_size)
    steps = ES8_COLLECT + ES8_DISCARD
    m.update(adapted_step_size=ch.step_size, adapted_traj_len=ch.traj_len,
             mean_leapfrogs_per_draw=lf, elapsed_s=elapsed,
             warm_up_and_first_run_s=warm_s,
             draws_per_sec=ES8_CHAINS * steps / elapsed,
             ess_per_sec=m["ess_mean"] / elapsed,
             grad_evals_per_effective_sample=ES8_CHAINS * steps * (lf + 1.0)
             / m["ess_mean"])
    say("eight_schools_chees", kernels="none (the lockstep tier)",
        **{k: repr(v) for k, v in m.items()})
    return m


# -- the run tooling (checkpoint.py, io/, utils' Timer and trace) ------------


def state_copy(state):
    """A copy of a sampler state's tensors (host ints as they are)."""
    return type(state)(*(x.clone() if torch.is_tensor(x) else x
                         for x in state))


def states_equal(a, b) -> bool:
    """Bit for bit, the tensors of ``b`` moved to ``a``'s device."""
    return type(a) is type(b) and all(
        torch.equal(x, y.to(x.device)) if torch.is_tensor(x) else x == y
        for x, y in zip(a, b))


def resume_case(label: str, sampler, fresh, run_args, path: str,
                launches: dict) -> dict:
    """``save_sampler`` of ``sampler``, then ``run(*run_args)`` on it and on
    ``fresh()`` (the same configuration, another seed) restored from the
    checkpoint: both cubes and final states equal bit for bit, and each
    continuation's counts exactly ``launches``. Returns the save and
    restore milliseconds (CUDA synchronised), the file's bytes, the
    saved state, the counts, the cube's shape and the restored
    sampler."""
    saved = state_copy(sampler.state)
    _, save_s = timed(lambda: save_sampler(path, sampler))
    reset_counts()
    cont_a = sampler.run(*run_args)
    torch.cuda.synchronize()
    counts_a = read_counts()
    other = fresh()
    _, restore_s = timed(lambda: restore_sampler(path, other))
    check(f"{label} restored state", states_equal(saved, other.state),
          label)
    reset_counts()
    cont_b = other.run(*run_args)
    torch.cuda.synchronize()
    counts_b = read_counts()
    want = counts_with(**launches)
    check(f"{label} continuation launches and no plain twin",
          counts_a == want and counts_b == want, (counts_a, counts_b))
    check(f"{label} continuation bit-equal", torch.equal(cont_a, cont_b)
          and states_equal(sampler.state, other.state), label)
    return {"save_ms": save_s * 1e3, "restore_ms": restore_s * 1e3,
            "bytes": os.path.getsize(path + ".pt"), "saved": saved,
            "counts": counts_a, "restored": other,
            "shape": tuple(cont_a.shape)}


def phase_checkpoint_flagship(hmc, dev, tmp: str) -> tuple:
    """The flagship after its timed run (65,536 chains, D = 3, L = 192,
    K = 16): ``save_sampler``, then ``run(1024)`` on it and on a flagship
    built from another seed and restored from the checkpoint; both cubes
    bit for bit and Kernel 2's 64 launches in each. Returns the
    checkpoint's path and the saved state."""
    path = os.path.join(tmp, "flagship")
    per = CKPT_FLAGSHIP_RUN // STEPS_PER_CALL
    r = resume_case("checkpoint_flagship", hmc, lambda: flagship(dev, 7),
                    (CKPT_FLAGSHIP_RUN, 0), path,
                    {"hmc_multistep": per})
    say("checkpoint_flagship", chains=N_CHAINS, dim=DIM, L=N_LEAPFROG,
        K=STEPS_PER_CALL, run=CKPT_FLAGSHIP_RUN, bit_equal=True,
        save_ms=repr(r["save_ms"]), restore_ms=repr(r["restore_ms"]),
        file_bytes=r["bytes"], launches_saved=per, launches_restored=per,
        **{k: v for k, v in r["counts"].items() if v})
    return path, r["saved"]


def phase_checkpoint_device(path: str, saved, dev) -> None:
    """The flagship checkpoint loaded with ``device="cpu"`` and restored
    into a CPU flagship (the twin tier): its state equals the card's bit
    for bit; ``load_checkpoint``'s default device is the card."""
    state, gen = mt.load_checkpoint(path, device="cpu")
    check("checkpoint_device cpu load", states_equal(saved, state)
          and all(x.device.type == "cpu" for x in state), "cpu load")
    on_card, _ = mt.load_checkpoint(path)
    check("checkpoint_device default is the card", states_equal(
        saved, on_card) and all(x.is_cuda for x in on_card), "card load")
    cpu = mt.HMC(mt.rosenbrock_nd(), torch.zeros((N_CHAINS, DIM)),
                 STEP_SIZE, N_LEAPFROG, use_pallas="full", jitter=JITTER,
                 steps_per_call=STEPS_PER_CALL, device="cpu")
    _, restore_s = timed(lambda: restore_sampler(path, cpu))
    equal = states_equal(saved, cpu.state)
    check("checkpoint_device state bit-equal on the CPU", equal
          and cpu.state.positions.device.type == "cpu"
          and torch.equal(cpu._gen.get_state(), gen.get_state()), equal)
    say("checkpoint_device", chains=N_CHAINS, cpu_state_equal=equal,
        default_device=on_card.positions.device,
        restore_cpu_ms=repr(restore_s * 1e3))


def phase_trace(hmc, dev, tmp: str) -> None:
    """One flagship ``run(1024)`` inside ``utils.profiling.trace``, timed
    with ``utils.time_blocked``: the trace file exists, parses as JSON and
    names Kernel 2. On the H100 the profiler now and then delivers a
    call's CUDA activity without its kernels (``device_profile``): a trace
    that lacks the kernel is taken again, three traces at most."""
    from mini_mcmc_torch.utils import profiling, time_blocked

    per = CKPT_FLAGSHIP_RUN // STEPS_PER_CALL
    for attempt in range(1, 4):
        log_dir = os.path.join(tmp, f"trace{attempt}")
        reset_counts()
        with profiling.trace(log_dir) as where:
            cube, secs = time_blocked(hmc.run, CKPT_FLAGSHIP_RUN, 0,
                                      time_major=True)
        counts = read_counts()
        check("trace launches", counts == counts_with(hmc_multistep=per),
              counts)
        files = os.listdir(where)
        check("trace file", len(files) == 1
              and files[0].endswith(".pt.trace.json"), files)
        trace_path = os.path.join(where, files[0])
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        k2 = [e for e in events if "multistep_kernel" in e.get("name", "")]
        if k2:
            break
    check("trace names Kernel 2", bool(k2), f"{attempt} traces")
    say("trace", run=CKPT_FLAGSHIP_RUN, time_blocked_s=repr(secs),
        launches=per, kernel_events=len(k2), events=len(events),
        trace_bytes=os.path.getsize(trace_path), attempts=attempt,
        kernel=repr(k2[0]["name"][:80]), finite=bool(
            torch.isfinite(cube).all()))


def phase_checkpoint_nuts(nuts, tuned, dev, tmp: str) -> None:
    """The NUTS stage's sampler after its adaptation (131,072 chains):
    saved, then ``run(128)`` on it and on a NUTS from another seed
    restored from the checkpoint: the cubes and epsilon, h_bar, m and the
    divergences bit for bit, Kernel 4 once a step (127) in each. Then the
    dense-metric sampler's checkpoint restored into that unmetriced NUTS
    raises ``ValueError`` naming the metric."""
    path = os.path.join(tmp, "nuts")
    steps = CKPT_NUTS_RUN - 1  # the NUTS convention
    r = resume_case(
        "checkpoint_nuts", nuts,
        lambda: mt.NUTS(nuts.target, nuts.positions, 0.8,
                        use_pallas="full").seed(99),
        (CKPT_NUTS_RUN,), path, {"nuts_step": steps})
    other = r["restored"]
    for f in ("epsilon", "epsilon_bar", "h_bar", "m", "divergences"):
        a, b = getattr(nuts.state, f), getattr(other.state, f)
        check(f"checkpoint_nuts {f}", torch.equal(a, b)
              if torch.is_tensor(a) else a == b, f)
    save_sampler(os.path.join(tmp, "nuts_dense"), tuned)
    raised = restore_raises(os.path.join(tmp, "nuts_dense"), other,
                            "metric")
    say("checkpoint_nuts", chains=NUTS_CHAINS, run=CKPT_NUTS_RUN,
        bit_equal=True, m=nuts.state.m,
        step_size_mean=repr(float(nuts.step_size.mean())),
        save_ms=repr(r["save_ms"]), restore_ms=repr(r["restore_ms"]),
        file_bytes=r["bytes"], launches_saved=steps,
        launches_restored=steps, metric_guard=repr(raised[:60]))


def phase_checkpoint_kernels(label, sampler, fresh, run_n: int,
                             launches: dict, tmp: str) -> dict:
    """One sampler of the ``[checkpoint_kernels]`` phase: saved, then one
    block (``run(run_n)``) continued on it and on ``fresh()`` restored
    from the checkpoint, bit for bit, the kernel's launches counted."""
    r = resume_case(f"checkpoint_{label}", sampler, fresh,
                    (run_n, 0), os.path.join(tmp, label), launches)
    say("checkpoint_kernels", sampler=label, run=run_n, bit_equal=True,
        shape=r["shape"], save_ms=repr(r["save_ms"]),
        restore_ms=repr(r["restore_ms"]), file_bytes=r["bytes"],
        **{k: v for k, v in r["counts"].items() if v})
    return r


def restore_raises(path: str, sampler, word: str) -> str:
    """The ``ValueError`` message of restoring ``path`` into ``sampler``,
    which must raise one naming ``word``."""
    try:
        restore_sampler(path, sampler)
    except ValueError as e:
        check(f"guard names {word}", word in str(e), str(e))
        return str(e)
    raise AssertionError(f"check FAILED [guard {word}]: restored")


def phase_checkpoint_constrained(mhc, tmp: str) -> None:
    """The constrained MH stage's sampler (Kernel 5's transformed instance)
    through ``[checkpoint_kernels]``; then its checkpoint restored into
    the same sampler without the transform raises ``ValueError`` naming
    the transform. The phase's last line."""
    phase_checkpoint_kernels(
        "mh_constrained", mhc, lambda: mt.MetropolisHastings(
            mhc.target, mhc.proposal, mhc.positions, use_pallas="full",
            steps_per_call=MH_K, transform=mhc.transform).seed(99), MH_K,
        {"mh_multistep": 1, "mh_multistep_transformed": 1}, tmp)
    plain = mt.MetropolisHastings(mhc.target, mhc.proposal, mhc.positions,
                                  use_pallas="full", steps_per_call=MH_K)
    guard = restore_raises(os.path.join(tmp, "mh_constrained"), plain,
                           "transform")
    say("checkpoint_kernels", samplers="mh,gibbs,separable,tempering,"
        "mh_constrained", bit_equal=True, transform_guard=repr(guard[:60]))


def phase_io(cube, tmp: str) -> dict:
    """The flagship cube's first 512 chains x 2,048 draws (1,048,576 rows)
    from the card: ``save_csv_tensor(native=True)`` and the Python writer,
    each file parsed with numpy equal to the cube (values exactly, the
    index columns), and rows/s of each writer. Arrow and Parquet where
    ``pyarrow`` imports (written, read back, compared; a streamed Parquet
    file equal to the one-shot export); where it does not, each of
    ``save_arrow``, ``save_parquet`` and ``ParquetStreamWriter`` raises
    ``RuntimeError`` naming pyarrow, and ``pyarrow: absent`` is printed."""
    import importlib.util

    import numpy as np

    from mini_mcmc_torch import io as mio
    from mini_mcmc_torch import native

    c, n, d = cube.shape
    rows = c * n
    # the native library builds before its writer is timed
    _, build_s = timed(native.load)
    want = cube.double().cpu().numpy().reshape(rows, d)
    idx = np.stack([np.repeat(np.arange(c), n), np.tile(np.arange(n), c)], 1)
    so, flags = native.build()
    m = {"rows": rows, "native_build_s": build_s, "native_library": so.name,
         "native_flags": " ".join(flags)}
    for writer, nat in (("native", True), ("python", False)):
        path = os.path.join(tmp, f"cube_{writer}.csv")
        _, sec = timed(lambda: mio.save_csv_tensor(cube, path, native=nat))
        with open(path) as f:
            header = f.readline()
        check(f"io {writer} header", header == "chain,observation," + ",".join(
            f"dim_{i}" for i in range(d)) + "\n", header)
        vals = np.loadtxt(path, delimiter=",", skiprows=1)
        check(f"io {writer} csv equals the cube", vals.shape == (rows, d + 2)
              and np.array_equal(vals[:, 2:], want)
              and np.array_equal(vals[:, :2], idx), writer)
        m[f"{writer}_s"] = sec
        m[f"{writer}_rows_per_s"] = rows / sec
        m[f"{writer}_bytes"] = os.path.getsize(path)
        os.remove(path)
    m["native_over_python"] = m["native_rows_per_s"] / m["python_rows_per_s"]
    have_pyarrow = importlib.util.find_spec("pyarrow") is not None
    if have_pyarrow:
        import pyarrow as pa
        import pyarrow.ipc  # noqa: F401
        import pyarrow.parquet as pq

        arrow_path = os.path.join(tmp, "cube.arrow")
        _, sec = timed(lambda: mio.save_arrow(cube, arrow_path))
        table = pa.ipc.open_file(arrow_path).read_all()
        got = np.stack([table.column(f"dim_{i}").to_numpy()
                        for i in range(d)], 1)
        check("io arrow equals the cube", np.array_equal(got, want), "arrow")
        m["arrow_rows_per_s"] = rows / sec
        tm = cube.transpose(0, 1)  # [n, c, d], the tensor schema
        one = os.path.join(tmp, "oneshot.parquet")
        mio.save_parquet_tensor(tm, one)
        streamed = os.path.join(tmp, "streamed.parquet")
        with mio.ParquetStreamWriter(streamed) as w:
            for start in range(0, n, n // 4):
                w.append(tm[start:start + n // 4], start)
        check("io streamed parquet equals the one-shot export",
              pq.read_table(streamed).equals(pq.read_table(one)), "parquet")
        m["pyarrow"] = pa.__version__
    else:
        print("pyarrow: absent", flush=True)
        raised = {}
        for name, call in (
                ("save_arrow", lambda: mio.save_arrow(
                    cube, os.path.join(tmp, "x.arrow"))),
                ("save_parquet", lambda: mio.save_parquet(
                    cube, os.path.join(tmp, "x.parquet"))),
                ("ParquetStreamWriter", lambda: mio.ParquetStreamWriter(
                    os.path.join(tmp, "y.parquet")))):
            try:
                call()
                raised[name] = None
            except RuntimeError as e:
                raised[name] = str(e)
        check("io without pyarrow: each table export raises RuntimeError "
              "naming it", all(v and "pyarrow" in v for v in raised.values()),
              raised)
        say("io_pyarrow", pyarrow="absent",
            **{k: repr(v) for k, v in raised.items()})
        m["pyarrow"] = "absent"
    say("io", shape=(c, n, d), **{k: repr(v) for k, v in m.items()})
    return m


def es8_targets(dev, metric=None) -> dict:
    """The eight-schools target in each CUDA form (ES8_FORMS), whitened
    by ``metric`` when one is given."""
    from mini_mcmc_torch.examples.eight_schools import make_noncentered_target

    out = {f: make_noncentered_target(f) for f in ES8_FORMS}
    if metric is not None:
        out = {f: mt.models.precondition_target(t, metric)
               for f, t in out.items()}
    return out


def user_requests(dev) -> list:
    """The libraries the eight-schools stages run: each form at D = 10,
    plain and under a diagonal metric (the two legs of ``warmed_up(300,
    "diag")``), as ``(source, dim, flags)``; the traced form is traced on
    the card. A metric's values are parameters, not source: one library
    serves every diagonal metric."""
    diag = mt.models.Preconditioner(
        "diag", scale=torch.ones(10, device=dev))
    reqs = []
    for metric in (None, diag):
        for t in es8_targets(dev, metric).values():
            reqs.append((t.dc_forms(10, dev).source, 10,
                         _build.instance_flags(t)))
    return reqs


def phase_user_build(reqs) -> dict:
    """``[user_build]``: each user library's build seconds (nvcc from the
    start of phase_build's one batch to its link) and the registers,
    stack frame and spills of every instance in it (``ptxas -v``)."""
    out = {}
    for (source, dim, flags), form in zip(reqs, ES8_FORMS * 2):
        so = user_density.library_path(source, dim, flags)
        log = so.with_suffix(".log").read_text()
        head = log.splitlines()[0]
        seconds = float(head.split()[-1]) if head.startswith(
            "build seconds") else float("nan")
        _, reported = ptxas_report(log)
        say("user_build", form=form, dim=dim, flags=flags, lib=so.name,
            nvcc_seconds=seconds, instances=len(reported))
        for kernel, info in reported.items():
            say("user_ptxas_instance", form=form, flags=flags,
                kernel=kernel[:72], **info)
            check(f"user instance {kernel[:40]} spills nothing",
                  info.get("spill_stores", 0) == 0, info)
        out[(form, flags)] = dict(nvcc_seconds=seconds, ptxas=reported)
    return out


def phase_user_probe(dev) -> dict:
    """``[user_probe]``: each form's compiled logp and gradient (the
    per-density library's probe entry) against the batch form and
    autograd on 4,096 rows of ``init_with_seed(4096, 10, seed=35)``: the
    worst absolute and relative errors; ``validate_dc_forms`` (the JAX
    tolerance rule) must pass on all of them."""
    from mini_mcmc_torch.models import validate_dc_forms

    x = mt.init_with_seed(ES8_CHAINS, 10, seed=ES8_FUSED_SEED, device=dev)
    out = {}
    for form, t in es8_targets(dev).items():
        lp, g = user_density.probe(t, x)
        want_lp, want_g = t.batch_logp_and_grad(x)
        validate_dc_forms(t, x, max_rows=x.shape[0])
        out[form] = {
            "logp_max_abs_err": max_abs_err(lp, want_lp),
            "logp_max_rel_err": float(((lp - want_lp).abs()
                                       / want_lp.abs().clamp(min=1.0))
                                      .max()),
            "grad_max_abs_err": max_abs_err(g, want_g),
            "grad_max_rel_err": float(((g - want_g).abs() / want_g.abs()
                                       .amax(dim=1, keepdim=True)
                                       .clamp(min=1.0)).max()),
        }
        say("user_probe", form=form, rows=x.shape[0],
            grad=t.dc_forms(10, dev).grad,
            **{k: repr(v) for k, v in out[form].items()})
    return out


def phase_eight_schools_fused(dev):
    """Eight schools on the fused NUTS tier (bench.py:1376-1447) with each
    CUDA form of the target (ES8_FORMS): ``NUTS(make_noncentered_target(
    form), init_with_seed(4096, 10, seed=35), 0.9, seed=35,
    use_pallas="full").warmed_up(300, "diag")`` and an untimed
    ``run(1024, 256)``; then bench.py's ``_timed_best``: TIMED_REPS timed
    ``run(1024, 256)`` of each form, the forms in turns, so that the
    host's speed, which sets these host-bound stages' time, is shared.
    Each timed run is counted (Kernel 4's whitened user instance once a
    step, no twin); :func:`es8_gates` on each form's last run at its
    fastest time, µs a step, ESS/s, and the derived and traced forms at
    least ES8_DERIVED_RATE times the hand-written ESS/s. Returns the
    samplers and the measures by form."""
    from mini_mcmc_torch.examples.eight_schools import make_noncentered_target

    c8, n8, nd8 = ES8_CHAINS, ES8_COLLECT, ES8_DISCARD
    steps = n8 + nd8 - 1
    samplers, warm_s = {}, {}
    for form in ES8_FORMS:
        t0 = time.perf_counter()
        nuts = mt.NUTS(make_noncentered_target(form), mt.init_with_seed(
            c8, 10, seed=ES8_FUSED_SEED, device=dev), 0.9,
            seed=ES8_FUSED_SEED, use_pallas="full").warmed_up(ES8_ADAPT,
                                                              "diag")
        first = nuts.run(n8, nd8)
        torch.cuda.synchronize()
        warm_s[form] = time.perf_counter() - t0
        del first
        check(f"eight_schools_fused {form} whitened diag instance",
              _build.instance_flags(nuts.kernel_target) == 5,
              _build.instance_flags(nuts.kernel_target))
        samplers[form] = nuts
    times = {form: [] for form in ES8_FORMS}
    samples = {}
    for _ in range(TIMED_REPS):
        for form, nuts in samplers.items():
            samples[form] = None
            reset_counts()
            t0 = time.perf_counter()
            samples[form] = nuts.run(n8, nd8)
            torch.cuda.synchronize()
            times[form].append(time.perf_counter() - t0)
            counts = read_counts()
            check(f"eight_schools_fused {form} launches and no twin",
                  counts == counts_with(nuts_step=steps,
                                        nuts_step_user=steps), counts)
    out = {}
    for form, nuts in samplers.items():
        label = "eight_schools_fused" + (
            "" if form == "hand" else f"_{form}")
        m = es8_gates(label, samples[form], nuts, min(times[form]), steps)
        m.update(timed_runs_s=times[form], warm_up_and_first_run_s=warm_s[
            form], kernel4_launches=steps,
            grad=nuts.kernel_target.dc_forms(10, dev).grad)
        if form != "hand":
            m["rate_vs_hand"] = m["ess_per_sec"] / out["hand"]["ess_per_sec"]
            check(f"{label} ESS/s >= {ES8_DERIVED_RATE} x hand-written",
                  m["rate_vs_hand"] >= ES8_DERIVED_RATE, m["rate_vs_hand"])
        samples[form] = None
        say(label, form=form, chains=c8, **{k: repr(v)
                                            for k, v in m.items()})
        out[form] = m
    return samplers, out


def user_starts(nuts, dev) -> dict:
    """The starts of the user instances' checks at eight schools'
    equilibrium (the hand stage's sampler after its timed run), by (form,
    kind): ``plain`` the target in x at the adapted steps times the
    metric's smallest scale, ``whitened`` the sampler's diagonal metric
    around the target in y at the adapted steps."""
    from types import SimpleNamespace

    x, y = nuts.positions.contiguous(), nuts.state.positions.contiguous()
    eps_y = nuts.step_size.contiguous()
    eps_x = (eps_y * float(nuts.metric.scale.min())).contiguous()
    out = {}
    for kind, targets, pos, eps in (
            ("plain", es8_targets(dev), x, eps_x),
            ("whitened", es8_targets(dev, nuts.metric), y, eps_y)):
        for form, t in targets.items():
            out[(form, kind)] = SimpleNamespace(
                kernel_target=t, state=SimpleNamespace(positions=pos),
                step_size=eps)
    return out


def phase_user_kernels(nuts, dev) -> dict:
    """``[user_kernels]``: at eight schools' equilibrium, each user
    instance of Kernels 1-4 (three forms, plain and whitened diag) against
    its plain twin as the built-in instances are held: Kernel 1 at L = 8
    and Kernel 2 at K = 16, L = 8 (positions per chain, and gradients,
    within RTOL/ATOL on NUTS_SHARE of the chains), Kernel 3 at j = 4
    (subtree_case) and Kernel 4 for one step (phase_nuts_step); each
    one's time by CUDA events and its device time alone
    (``torch.profiler``), the twins' times (the hand form: a twin runs the
    batch form whatever the source). Then the use_pallas=True and "full"
    HMC tiers and the use_pallas=True NUTS tier on the hand form's plain
    target, counted (Kernels 1, 2 and 3's user instances on their tiers).
    Returns the measures by (kernel, form, kind), the twins' details for
    the bounds and the tier launches."""
    starts = user_starts(nuts, dev)
    res, details, sub_leaves = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(0x5EED_1616)
    for (form, kind), st in starts.items():
        t, pos = st.kernel_target, st.state.positions
        c, d = pos.shape
        eps0 = st.step_size.median().reshape(())
        mom = torch.randn(pos.shape, generator=gen, device=dev)
        logp, grad = t.batch_logp_and_grad(pos)
        k1_args = (t, pos, mom, grad, eps0, 8)
        got, want = leapfrog_trajectory(*k1_args), \
            leapfrog_trajectory_plain(*k1_args)
        ok = chain_agree(got[0], want[0]) & grad_agree(got[3], want[3])
        ok &= chain_agree(got[1], want[1]) & chain_agree(got[2], want[2])
        e1 = max(max_abs_err(a, b) for a, b in zip(got, want))
        check(f"user leapfrog {form} {kind}",
              float(ok.double().mean()) >= NUTS_SHARE,
              float(ok.double().mean()))
        eps_k = eps0.expand(STEPS_PER_CALL).contiguous()
        k2_args = (t, pos, logp, grad, eps_k, 8, 0x5EED_2222, 17)
        got2, want2 = hmc_multistep(*k2_args), hmc_multistep_plain(*k2_args)
        ok2 = chain_agree(got2[0], want2[0]) & chain_agree(got2[1], want2[1])
        e2 = max_abs_err(got2[0], want2[0], ok2)
        check(f"user multistep {form} {kind}",
              float(ok2.double().mean()) >= NUTS_SHARE,
              float(ok2.double().mean()))
        e3, done, per_leaf = subtree_case(
            st, dev, 4, seed=164, label=f"user_subtree_{form}_{kind}")
        e4, det, step_args = phase_nuts_step(
            st, dev, label=f"user_nuts_step_{form}_{kind}")
        sub_args = subtree_inputs(st, dev, 4, seed=164)
        launches = {
            "leapfrog": lambda: leapfrog_trajectory(*k1_args),
            "multistep": lambda: hmc_multistep(*k2_args),
            "subtree": lambda: subtree(*sub_args),
            "nuts_step": lambda: nuts_step(*step_args),
        }
        names = {"leapfrog": "leapfrog_kernel",
                 "multistep": "multistep_kernel",
                 "subtree": "subtree_kernel",
                 "nuts_step": "nuts_step_kernel"}
        device = device_ms_each({names[k]: fn for k, fn in launches.items()},
                                reps=20)
        for k, fn in launches.items():
            res.setdefault((k, form, kind), {}).update({
                "ms": cuda_ms(fn, 20),
                "device_ms": device[names[k]],
                "err": {"leapfrog": e1, "multistep": e2, "subtree": e3,
                        "nuts_step": e4}[k],
            })
        if form == "hand":
            for k, fn in (
                    ("leapfrog", lambda: leapfrog_trajectory_plain(
                        *k1_args)),
                    ("multistep", lambda: hmc_multistep_plain(*k2_args)),
                    ("subtree", lambda: subtree_plain(*sub_args)),
                    ("nuts_step", lambda: nuts_step_plain(*step_args))):
                plain_ms = cuda_ms(fn, 2)
                for f in ES8_FORMS:
                    res.setdefault((k, f, kind), {})["plain_ms"] = plain_ms
        details[(form, kind)] = det
        sub_leaves[(form, kind)] = done
        say("user_kernels", form=form, kind=kind, chains=c, D=d,
            flags=_build.instance_flags(t),
            **{f"{k}_{q}": repr(v) for k in launches
               for q, v in res[(k, form, kind)].items()})

    # the tiers of Kernels 1-3 on the hand form's plain target, counted
    st = starts[("hand", "plain")]
    x, eps = st.state.positions, float(st.step_size.median())
    tiers = {}
    for name, run, kernel in (
            ("hmc_true", lambda: mt.HMC(st.kernel_target, x, eps, 8,
                                        use_pallas=True).seed(5).run(8),
             "leapfrog_trajectory"),
            ("hmc_full", lambda: mt.HMC(st.kernel_target, x, eps, 8,
                                        use_pallas="full",
                                        steps_per_call=STEPS_PER_CALL)
             .seed(5).run(2 * STEPS_PER_CALL), "hmc_multistep"),
            ("nuts_true", lambda: mt.NUTS(st.kernel_target, x, 0.9,
                                          use_pallas=True).seed(5)
             .run(4, 4), "nuts_subtree")):
        reset_counts()
        sample = run()
        torch.cuda.synchronize()
        counts = read_counts()
        check(f"user tier {name} runs its kernel's user instance",
              counts[kernel] > 0 and counts[f"{kernel}_user"]
              == counts[kernel] and bool(torch.isfinite(sample).all()),
              counts)
        tiers[kernel] = counts[kernel]
        say("user_tier_run", tier=name, kernel=kernel,
            launches=counts[kernel], shape=tuple(sample.shape))
    return {"res": res, "details": details, "subtree_leaves": sub_leaves,
            "tiers": tiers}


def phase_k4_user_alone(uk, nuts) -> None:
    """``[k4_user_alone]``: Kernel 4's user instances at eight schools'
    shape (D = 10, 4,096 chains) as phase_user_kernels launched them:
    the launched grid (threads a block, a chain a thread; blocks per SM
    and blocks), the deepest chain's doublings and each instance's device
    µs alone; and the device's idle share over a profiled ``run(64, 0)``
    of the hand stage's sampler ``nuts``."""
    det = uk["details"][("hand", "whitened")]
    grid = det["grid"]
    idle = idle_share(lambda: nuts.run(64, 0))
    say("k4_user_alone", threads=grid["threads"],
        blocks_per_sm=grid["blocks_per_sm"], blocks=grid["blocks"],
        chain_depth_max=int(det["depth"].max()),
        fused_idle_share=idle["idle_share"],
        fused_profiled_us_per_step=idle["profiled_wall_s"] / 64 * 1e6,
        **{f"{form}_{kind}_us": repr(None if v["device_ms"] is None
                                     else v["device_ms"] * 1e3)
           for (k, form, kind), v in uk["res"].items()
           if k == "nuts_step"})


def user_bounds(uk) -> dict:
    """bound_ms and bound_by of each user instance at the shapes of
    phase_user_kernels (C = 4,096, D = 10), by (kernel, kind): the work
    of the eight-schools density whatever the form (its hand-written
    gradient's operations: the least the function needs), the diagonal
    metric's products when whitened; Kernels 3 and 4 count the twin's
    leaves, merges and doublings."""
    c, d, k, L = ES8_CHAINS, 10, STEPS_PER_CALL, 8
    out = {}
    for kind in ("plain", "whitened"):
        w = OPS["diag_d10"] if kind == "whitened" else 0
        grad = OPS["es8_grad"] + w
        logp = OPS["es8_logp"] + w
        leaf = OPS["d10_leapfrog"] + grad + logp + OPS["d10_leaf_rest"]
        out[("leapfrog", kind)] = bound(
            4 * (3 * c * d + 1 + c * (3 * d + 1)),
            c * (L * (OPS["d10_leapfrog"] + grad) + logp))
        out[("multistep", kind)] = bound(
            4 * (c * (2 * d + 1) * 2 + k + k * c * d),
            c * k * (L * (OPS["d10_leapfrog"] + grad) + logp
                     + rng_ops(d, 1) + OPS["hmc_step"]))
        sub = float(uk["subtree_leaves"][("hand", kind)].double().sum())
        out[("subtree", kind)] = bound(
            c * (4 * (3 * d + 4) + 1) + c * (4 * 5 * d + 4 * 4 + 2),
            c * (grad + logp) + sub * leaf
            + max(sub - c, 0.0) * (OPS["d10_merge"] + OPS["hash_draw"]))
        det = uk["details"][("hand", kind)]
        leaves_c = det["leaves"].double()
        depth_c = det["depth"].double()
        merges_c = (leaves_c - depth_c).clamp(min=0.0)
        out[("nuts_step", kind)] = bound(
            4 * (c * d * 2 + c + 4 * c),
            c * (grad + logp + OPS["nuts_step"])
            + float(rng_ops(d, 1 + 2 * depth_c + merges_c).sum())
            + float(leaves_c.sum()) * leaf
            + float(merges_c.sum()) * OPS["d10_merge"]
            + float(depth_c.sum()) * OPS["d10_doubling"])
    return out


def user_records(record, b: dict, uk: dict, es8m: dict,
                 user_build: dict) -> tuple[list, list]:
    """The kernels line's records of the user instances of Kernels 1-4
    (eight schools, D = 10, each form): Kernel 4's whitened instance on
    the three fused stages' main paths (its plain instance runs in their
    first warm-up leg), Kernels 1-3 off the main paths with the hand
    form's counted tier runs. ``b`` gains each record's bound. Returns
    (main-path records, off-path records)."""
    res = uk["res"]
    src = {"nuts_step": ("nuts_full.cuh", "nuts_full.py:48"),
           "subtree": ("nuts_subtree.cuh", "nuts_subtree.py:243"),
           "leapfrog": ("hmc_leapfrog.cuh", "hmc.py:46"),
           "multistep": ("hmc_multistep.cuh", "hmc_full.py:86")}
    wrapper = {"nuts_step": "nuts_step", "subtree": "nuts_subtree",
               "leapfrog": "leapfrog_trajectory",
               "multistep": "hmc_multistep"}
    main, off = [], []
    for k in ("nuts_step", "subtree", "leapfrog", "multistep"):
        for form in ES8_FORMS:
            w, pl = res[(k, form, "whitened")], res[(k, form, "plain")]
            name = f"{wrapper[k]}_user_{form}"
            b[name] = b[f"{k}_user_whitened"]
            rec = record(
                name, src[k][0], src[k][1],
                es8m[form]["kernel4_launches"] if k == "nuts_step" else 0,
                w["err"], w["ms"], w["plain_ms"],
                instance=f"WhitenedDiag<User<Density>, 10> ({form})",
                device_ms=w["device_ms"], ms_plain_instance=pl["ms"],
                device_ms_plain_instance=pl["device_ms"],
                plain_ms_plain_instance=pl["plain_ms"],
                max_abs_err_plain_instance=pl["err"],
                bound_ms_plain_instance=b[f"{k}_user_plain"][0],
                bound_by_plain_instance=b[f"{k}_user_plain"][1],
                nvcc_seconds=user_build[(form, 5)]["nvcc_seconds"],
                nvcc_seconds_plain_instance=user_build[(form, 0)][
                    "nvcc_seconds"])
            if k == "nuts_step":
                main.append(rec)
                continue
            if form == "hand":
                rec["tier_run_launches_plain_instance"] = uk["tiers"][
                    wrapper[k]]
            off.append(rec)
    return main, off


# --------------------------------------------------------------------------
# User forms inside Kernels 5-8 (38)


#: the logistic coordinates of [sep_user]: scale s_d = logspace(-0.5, 0.5,
#: D), eps 0.15 (acceptance ~0.76 at L = 10 on the CPU twin: 0.1 gives
#: 0.89, 0.2 0.70, 0.25 0.54)
LOGISTIC_EPS = 0.15
LOGISTIC_VAR = math.pi ** 2 / 3.0
#: the D of [pt_user]'s check of Kernel 8's user instance past D = 2
PT_USER_DIM = 5
#: the Ds of [mh_user]'s checks of Kernel 5's user instance past D = 3
#: (mh_multistep.cuh, kLean)
MH_USER_DIMS = (5, 16)
#: the scaled walk of [mh_user_proposal]
SCALED_WALK = (0.8, 1.25)


def logistic_scales(dev) -> torch.Tensor:
    return torch.logspace(-0.5, 0.5, SEP_DIM, dtype=torch.float32,
                          device=dev)


def user_gaussian(dev, dim: int) -> "mt.models.Target":
    """A Gaussian at D = ``dim`` with standard deviations 0.5..2.5 (a
    closure constant the generated C++ reads with __ldg), a plain batch
    form."""
    s = torch.linspace(0.5, 2.5, dim, device=dev)
    return mt.models.Target(
        logp=lambda x: -0.5 * torch.sum((x / s.to(x.device)) ** 2, dim=-1))


def logistic_wrapped(dev) -> dict:
    """The hand logistic under a diagonal metric (Scaled<UserCoord>) and
    under ``interval(-24, 24)`` on every coordinate (TransformedCoord)."""
    from mini_mcmc_torch.examples import user_forms as F

    t = F.logistic(logistic_scales(dev))
    metric = mt.models.Preconditioner(
        "diag", scale=logistic_scales(dev).flip(0).contiguous())
    tf = mt.CoordinateTransform({i: mt.interval(-24.0, 24.0)
                                 for i in range(SEP_DIM)}, dim=SEP_DIM)
    return {"scaled": mt.models.precondition_target(t, metric),
            "transformed": tf.wrap(t)}


def k5678_user_requests(dev) -> list:
    """The per-form libraries of the user stages of Kernels 5-8 (38), as
    ``user_density.Spec``: the value-only libraries of each user density
    (MH's isotropic walk, tempering and the value probe) and of the
    built-in Gaussian2D beside each user proposal, the Gibbs library of the
    user mixture conditional, and Kernel 7's libraries of each coordinate
    functor (traced standard normal, hand and derived logistic; the hand
    logistic scaled and transformed). Traced forms are traced on the card."""
    from mini_mcmc_torch.examples import user_forms as F

    g2 = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    reqs = [user_density.value_spec(t, None, d, dev)[0] for t, d in (
        (F.gaussian2d_user([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]], False), 2),
        (F.gaussian2d_user([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]), 2),
        (F.rosenbrock_banana(), 2), (F.bimodal(PT_W_PLUS), 1),
        (F.bimodal(PT_W_PLUS, hand=True), 1),
        *((user_gaussian(dev, d), d)
          for d in sorted({PT_USER_DIM, *MH_USER_DIMS})))]
    reqs += [user_density.value_spec(g2, p, 2, dev)[0] for p in (
        F.isotropic_walk(1.0), F.scaled_walk(SCALED_WALK))]
    reqs.append(user_density.gibbs_spec(F.mixture_conditional(*MIX), 2))
    wrapped = logistic_wrapped(dev)
    for t, flags in ((mt.models.Target(logp=mt.standard_normal().logp), 0),
                     (F.logistic(logistic_scales(dev)), 0),
                     (F.logistic(logistic_scales(dev), hand=False), 0),
                     (wrapped["scaled"], 1), (wrapped["transformed"], 2)):
        reqs.append(user_density.sep_spec(t, flags, SEP_DIM, dev)[0])
    return reqs


def phase_k5678_user_build(reqs) -> dict:
    """``[user_build]`` for the libraries of Kernels 5-8's user forms:
    nvcc seconds (from the start of phase_build's one batch to each
    link) and each instance's registers, stack frame and spills; none
    may spill."""
    out = {}
    for spec in reqs:
        so = user_density.library_path(*spec)
        log = so.with_suffix(".log").read_text()
        head = log.splitlines()[0]
        seconds = float(head.split()[-1]) if head.startswith(
            "build seconds") else float("nan")
        _, reported = ptxas_report(log)
        label = f"{spec.kind}:{spec.types}:D={spec.dim}:flags={spec.flags}"
        say("user_build", form=repr(label), lib=so.name,
            nvcc_seconds=seconds, instances=len(reported))
        for kernel, info in reported.items():
            say("user_ptxas_instance", lib=so.name, kernel=kernel[:72],
                **info)
            check(f"user instance {kernel[:40]} spills nothing",
                  info.get("spill_stores", 0) == 0, info)
        out[so.name] = dict(nvcc_seconds=seconds, ptxas=reported)
    return out


def mh_gates(label: str, sample, elapsed: float) -> dict:
    """bench.py:416-421's four gates on an MH stage's time-major cube
    (R-hat, the means, the variances, the ESS floor) and its rates."""
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    mean = sample.mean(dim=(0, 1))
    var = sample.var(dim=(0, 1), unbiased=False)
    total = sample.shape[0] * sample.shape[1]
    m = {"elapsed_s": elapsed, "rhat_mean": float(rhat.mean()),
         "ess_mean": float(ess.mean()), "mean": [float(v) for v in mean],
         "var": [float(v) for v in var],
         "accept_rate": float((sample[1:] != sample[:-1]).any(dim=2)
                              .float().mean())}
    check(f"{label} rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    for d in range(sample.shape[2]):
        check(f"{label} mean[{d}]", abs(m["mean"][d]) <= 0.03, m["mean"])
        check(f"{label} var[{d}]", abs(m["var"][d] - 1.0) <= 0.05, m["var"])
    check(f"{label} ess floor", m["ess_mean"] >= 0.02 * total,
          (m["ess_mean"], total))
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = total / elapsed
    return m


def counted_run(label: str, sampler, run_args: tuple, want: dict,
                time_major: bool = True):
    """A warm-up run of ``sampler`` (its library built at construction),
    then one timed run, its counts held to ``counts_with(**want)``:
    ``(sample, seconds, counts)``."""
    warm = sampler.run(*run_args, time_major=time_major)
    torch.cuda.synchronize()
    del warm
    reset_counts()
    t0 = time.perf_counter()
    sample = sampler.run(*run_args, time_major=time_major)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    check(f"{label} launches, user instance and no twin",
          counts == counts_with(**want), counts)
    return sample, elapsed, counts


def chain_decisions_agree(a, b) -> torch.Tensor:
    """Per chain of two time-major cubes: every step's accept decision (a
    row that moved) the same."""
    return ((a[1:] != a[:-1]).any(dim=2) == (b[1:] != b[:-1]).any(dim=2)
            ).all(dim=0)


def kernel_times(fn, plain_fn, name: str) -> dict:
    """A launch's ms by CUDA events, its device ms alone (profiler) and its
    twin's ms."""
    return {"ms": cuda_ms(fn, 20), "device_ms": device_ms_per_launch(
        fn, name), "plain_ms": cuda_ms(plain_fn, 2)}


def mh_block_args(mh, k_steps: int, seed: int):
    s = mh.state
    hk = torch.empty((k_steps,) + tuple(s.positions.shape),
                     dtype=s.positions.dtype, device=s.positions.device)
    return (mh.kernel_target, mh.proposal, s.positions, s.logp, seed, 0,
            k_steps), hk


def phase_mh_user(dev):
    """``[mh_user]``: the MH stage of bench.py:391-431 (Gaussian2D, 65,536
    chains, 2,048 draws, K = 16) with its density as a user Target, traced
    from the batch form and as the hand ``cuda_source`` that copies
    targets.cuh:Gaussian2D, beside the built-in functor from the same seed
    and start: a warm-up run and one timed run each (counted_run), Kernel
    5's 128 launches a run (the user instance's), bench.py's four gates on each, the hand cube equal
    to the built-in's bit for bit and the traced form's per-chain accept
    decisions the built-in's on MH_SHARE of the chains. Then
    examples/rosenbrock_mh.py's density (proposal std 0.5) through the
    traced route at the same shape: a counted run and one K-block against
    its twin (phase_mh_kernel). Then the instance past D = 3 (kLean) at D
    in MH_USER_DIMS on user_gaussian: one K-block against its twin. Each
    user instance's times and the launches its counted run read. Returns
    the measures by form and the built-in cube."""
    from mini_mcmc_torch.examples import user_forms as F

    mean, cov = [0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]]
    init = mt.init_with_seed(MH_CHAINS, 2, seed=8, device=dev)
    per_run = MH_COLLECT // MH_K
    walk = mt.isotropic_gaussian_proposal(1.0)
    cubes, out = {}, {}
    for form, target in (("builtin", mt.gaussian2d(mean, cov)),
                         ("hand", F.gaussian2d_user(mean, cov)),
                         ("traced", F.gaussian2d_user(mean, cov, False))):
        mh = mt.MetropolisHastings(target, walk, init, use_pallas="full",
                                   steps_per_call=MH_K).seed(8)
        user = per_run if form != "builtin" else 0
        sample, elapsed, counts = counted_run(
            f"mh_user {form}", mh, (MH_COLLECT, 0),
            dict(mh_multistep=per_run, mh_multistep_user=user))
        m = mh_gates(f"mh_user {form}", sample, elapsed)
        m["launches"] = counts["mh_multistep_user"]
        if form != "builtin":
            args, hk = mh_block_args(mh, MH_K, 0x5EED_0A0A)
            m.update(kernel_times(lambda: mh_multistep(*args, hk),
                                  lambda: mh_multistep_plain(*args, hk),
                                  "mh_multistep_kernel"))
            m["err"] = phase_mh_kernel(mh, f"user_{form}", MH_K,
                                       0x5EED_0B0B)["err"]
        cubes[form] = sample
        out[form] = m
        del mh
    out["hand"]["cube_equal_builtin"] = bool(torch.equal(cubes["hand"],
                                                         cubes["builtin"]))
    agree = chain_decisions_agree(cubes["traced"], cubes["builtin"])
    out["traced"]["share_chains_decisions_builtin"] = float(
        agree.float().mean())
    out["traced"]["share_chains_cube_builtin"] = float(
        (cubes["traced"] == cubes["builtin"]).all(dim=2).all(dim=0)
        .float().mean())
    check("mh_user hand cube equals the built-in's bit for bit",
          out["hand"]["cube_equal_builtin"], "differs")
    check("mh_user traced decisions agree with the built-in's",
          out["traced"]["share_chains_decisions_builtin"] >= MH_SHARE,
          out["traced"]["share_chains_decisions_builtin"])
    builtin_cube = cubes.pop("builtin")
    del cubes
    # examples/rosenbrock_mh.py's density through the traced route
    rb = mt.MetropolisHastings(F.rosenbrock_banana(),
                               mt.isotropic_gaussian_proposal(0.5), init,
                               use_pallas="full", steps_per_call=MH_K).seed(0)
    sample, elapsed, counts = counted_run(
        "mh_user rosenbrock", rb, (MH_COLLECT, 0),
        dict(mh_multistep=per_run, mh_multistep_user=per_run))
    m = {"elapsed_s": elapsed, "launches": counts["mh_multistep_user"],
         "finite": bool(torch.isfinite(sample).all()),
         "x_mean": float(sample[..., 0].mean()),
         "y_mean": float(sample[..., 1].mean())}
    check("mh_user rosenbrock finite", m["finite"], "non-finite")
    del sample
    m["err"] = phase_mh_kernel(rb, "user_rosenbrock", MH_K,
                               0x5EED_0C0C)["err"]
    args, hk = mh_block_args(rb, MH_K, 0x5EED_0A0A)
    m.update(kernel_times(lambda: mh_multistep(*args, hk),
                          lambda: mh_multistep_plain(*args, hk),
                          "mh_multistep_kernel"))
    out["rosenbrock"] = m
    del rb
    # Kernel 5's user instance past D = 3 (kLean: the accept's logf before
    # the proposal) against its twin for one K-block
    for dim in MH_USER_DIMS:
        mh = mt.MetropolisHastings(
            user_gaussian(dev, dim),
            mt.isotropic_gaussian_proposal(2.0 / math.sqrt(dim)),
            mt.init_with_seed(MH_CHAINS, dim, seed=9, device=dev),
            use_pallas="full", steps_per_call=MH_K).seed(9)
        out[f"d{dim}"] = phase_mh_kernel(mh, f"user_d{dim}", MH_K,
                                         0x5EED_0E0E + dim)
        del mh
    for form, m in out.items():
        say("mh_user", form=form, chains=MH_CHAINS, K=MH_K,
            **{k: repr(v) for k, v in m.items()})
    return out, builtin_cube


def phase_mh_user_proposal(builtin_cube, dev) -> dict:
    """``[mh_user_proposal]``: the MH stage with
    ``isotropic_gaussian_proposal``'s walk as a user proposal source
    (examples/user_forms.py:isotropic_walk) on the built-in Gaussian2D from
    [mh_user]'s seed and start: one counted run, its cube equal to the
    built-in proposal's bit for bit; then the per-coordinate-scale walk
    (scales 0.8, 1.25): a counted run, bench.py's gates, one K-block
    against its twin. Each instance's times."""
    from mini_mcmc_torch.examples import user_forms as F

    target = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    init = mt.init_with_seed(MH_CHAINS, 2, seed=8, device=dev)
    per_run = MH_COLLECT // MH_K
    out = {}
    for form, walk in (("isotropic", F.isotropic_walk(1.0)),
                       ("scaled", F.scaled_walk(SCALED_WALK))):
        mh = mt.MetropolisHastings(target, walk, init, use_pallas="full",
                                   steps_per_call=MH_K).seed(8)
        sample, elapsed, counts = counted_run(
            f"mh_user_proposal {form}", mh, (MH_COLLECT, 0),
            dict(mh_multistep=per_run, mh_multistep_user=per_run))
        m = mh_gates(f"mh_user_proposal {form}", sample, elapsed)
        m["launches"] = counts["mh_multistep_user"]
        if form == "isotropic":
            m["cube_equal_builtin"] = bool(torch.equal(sample, builtin_cube))
            check("mh_user_proposal isotropic cube equals the built-in's",
                  m["cube_equal_builtin"], "differs")
        del sample
        m["err"] = phase_mh_kernel(mh, f"user_proposal_{form}", MH_K,
                                   0x5EED_0D0D)["err"]
        args, hk = mh_block_args(mh, MH_K, 0x5EED_0A0A)
        m.update(kernel_times(lambda: mh_multistep(*args, hk),
                              lambda: mh_multistep_plain(*args, hk),
                              "mh_multistep_kernel"))
        say("mh_user_proposal", form=form, chains=MH_CHAINS, K=MH_K,
            **{k: repr(v) for k, v in m.items()})
        out[form] = m
    return out


def pt_gates(label: str, pt, sample, elapsed: float) -> dict:
    """bench.py:890-898's four gates on a tempering stage's cold cube."""
    xs = sample.reshape(-1)
    plus = xs[xs > 0].double()
    swap = pt.swap_acceptance
    m = {"elapsed_s": elapsed, "mode_weight": float((xs > 0).float().mean()),
         "plus_mean": float(plus.mean()),
         "plus_std": float(plus.std(unbiased=False)),
         "swap_acceptance": [float(v) for v in swap],
         "cold_draws_per_sec": sample.shape[0] * sample.shape[1] / elapsed}
    check(f"{label} mode weight", abs(m["mode_weight"] - PT_W_PLUS) <= 0.05,
          m["mode_weight"])
    check(f"{label} mode mean", abs(m["plus_mean"] - 8.0) <= 0.05,
          m["plus_mean"])
    check(f"{label} mode std", abs(m["plus_std"] - 0.5) <= 0.05,
          m["plus_std"])
    check(f"{label} swap rates alive", bool((swap > 0.05).all()),
          m["swap_acceptance"])
    return m


def pt_user_kernel(target, dim: int, dev, seed: int, label: str) -> dict:
    """Kernel 8's user instance against its twin for one K-block at D =
    ``dim`` (PT_CHAINS chains, PT_TEMPS rungs of geometric_betas(8,
    0.01), scale 1) from a state drawn from N(0, 1): positions, logp,
    swap EWMA and history rows within MH_RTOL/MH_ATOL (the density's
    C++ against its batch form) on MH_SHARE of the chains, and the
    instance's times."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    betas = mt.geometric_betas(PT_TEMPS, 0.01)
    t, c = PT_TEMPS, PT_CHAINS
    pos = torch.randn((t, dim, c), generator=gen, device=dev)
    logp = target.batch_logp(pos.permute(0, 2, 1).reshape(t * c, dim))
    logp = logp.reshape(t, c).contiguous()
    sa = torch.zeros((t - 1, c), device=dev)
    lad = make_ladder(betas, 1.0, dim, dev)
    hk = torch.empty((PT_K, c, dim), device=dev)
    hp = torch.empty_like(hk)
    args = (target, pos, logp, sa, 0, lad, seed, 0, PT_K, 1)
    got = pt_multistep(*args, hk)
    want = pt_multistep_plain(*args, hp)
    torch.cuda.synchronize()
    ok = {"positions": within_tol(got[0], want[0]).all(1).all(0),
          "logp": within_tol(got[1], want[1]).all(0),
          "swap_accept": within_tol(got[2], want[2]).all(0),
          "history": within_tol(hk, hp).all(2).all(0)}
    shares = {k: float(v.float().mean()) for k, v in ok.items()}
    err = max(max_abs_err(hk.transpose(0, 1), hp.transpose(0, 1)),
              max_abs_err(got[0], want[0]))
    m = {"err": err, **{f"share_{k}": v for k, v in shares.items()},
         "accept_rate": float((hk[1:] != hk[:-1]).float().mean())}
    for k, v in shares.items():
        check(f"{label} {k}", v >= MH_SHARE, shares)
    m.update(kernel_times(lambda: pt_multistep(*args, hk),
                          lambda: pt_multistep_plain(*args, hp),
                          "pt_multistep_kernel"))
    say(label, D=dim, K=PT_K, T=t, chains=c,
        **{k: repr(v) for k, v in m.items()})
    return m


def phase_pt_user(dev) -> dict:
    """``[pt_user]``: the tempering stage of bench.py:858-905 (8,192
    chains x 8 rungs of geometric_betas(8, 0.01), proposal std 1, K = 16,
    run(2048) from -8) with bench's own density as a user Target, traced
    through ``logaddexp`` and as a hand ``cuda_source``
    (examples/user_forms.py:bimodal): a warm-up run and one timed run
    each, Kernel 8's 128 launches a run (the user instance's), the four
    gates of bench.py:890-898; each instance against its twin for one
    K-block (phase_pt_kernel: equal per chain) and its times. Then Kernel
    8's user instance at D = 5 against its twin (pt_user_kernel: the
    normals past D = 2 from draws p T + t)."""
    from mini_mcmc_torch.examples import user_forms as F

    per_run = PT_COLLECT // PT_K
    out = {}
    for form, hand in (("traced", False), ("hand", True)):
        pt = mt.ParallelTempering(
            F.bimodal(PT_W_PLUS, hand=hand),
            torch.full((PT_CHAINS, 1), -8.0, device=dev),
            betas=mt.geometric_betas(PT_TEMPS, 0.01), proposal_std=1.0,
            steps_per_call=PT_K, use_pallas="full").seed(5)
        sample, elapsed, counts = counted_run(
            f"pt_user {form}", pt, (PT_COLLECT, 0),
            dict(pt_multistep=per_run, pt_multistep_user=per_run))
        m = pt_gates(f"pt_user {form}", pt, sample, elapsed)
        m["launches"] = counts["pt_multistep_user"]
        del sample
        k = phase_pt_kernel(pt, 0x5EED_8989, label=f"pt_kernel_user_{form}",
                            exact=False)
        m.update(err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"],
                 device_ms=k["device_ms"])
        say("pt_user", form=form, chains=PT_CHAINS, T=PT_TEMPS, K=PT_K,
            **{k: repr(v) for k, v in m.items()})
        out[form] = m
    out["d5"] = pt_user_kernel(user_gaussian(dev, PT_USER_DIM),
                               PT_USER_DIM, dev, 0x5EED_8A8A, "pt_user_d5")
    return out


def phase_gibbs_user(dev) -> dict:
    """``[gibbs_user]``: the Gibbs stage of bench.py:434-478 (mixture,
    65,536 chains, 8,192 + 8,192 sweeps, K = 32) with the mixture
    conditional as a user ``cuda_source`` and ``sample_words``
    (examples/user_forms.py:mixture_conditional) beside the built-in
    conditional from the same seed: the warm-up run, then one timed run
    each, Kernel 6's 256 launches a run (the user instance's), the four
    gates of bench.py:464-467 on the user cube, which must equal the
    built-in's bit for bit; the user instance against its twin for one
    K-block (phase_gibbs_kernel) and its times."""
    from mini_mcmc_torch.examples import user_forms as F

    mu0, sigma0, mu1, sigma1, pi0 = MIX
    per_run = GIBBS_COLLECT // GIBBS_K
    cubes, samplers = {}, {}
    for form, cond in (("builtin", mt.gaussian_mixture_conditional(*MIX)),
                       ("user", F.mixture_conditional(*MIX))):
        g = mt.GibbsSampler(cond, torch.zeros((MH_CHAINS, 2), device=dev),
                            use_pallas="full", steps_per_call=GIBBS_K).seed(42)
        user = per_run if form == "user" else 0
        cubes[form], elapsed, counts = counted_run(
            f"gibbs_user {form}", g, (GIBBS_COLLECT, 0),
            dict(gibbs_multistep=per_run, gibbs_multistep_user=user))
        samplers[form] = (g, elapsed, counts["gibbs_multistep_user"])
    g, elapsed, launches = samplers["user"]
    sample = cubes["user"]
    equal = bool(torch.equal(sample, cubes["builtin"]))
    del cubes["builtin"]
    x = sample[:, :, 0]
    true_mean = pi0 * mu0 + (1 - pi0) * mu1
    true_var = (pi0 * (sigma0**2 + (mu0 - true_mean) ** 2)
                + (1 - pi0) * (sigma1**2 + (mu1 - true_mean) ** 2))
    rhat, _ = mt.split_rhat_mean_ess(sample, time_major=True)
    m = {"elapsed_s": elapsed, "x_mean": float(x.mean()),
         "x_var": float(x.var(unbiased=False)),
         "z_freq": float(sample[:, :, 1].mean()),
         "rhat_mean": float(rhat.mean()), "cube_equal_builtin": equal,
         "launches": launches,
         "draws_per_sec": MH_CHAINS * GIBBS_COLLECT / elapsed}
    del sample, x, cubes
    check("gibbs_user x mean", abs(m["x_mean"] - true_mean) <= 0.05,
          m["x_mean"])
    check("gibbs_user x var", abs(m["x_var"] - true_var) <= 0.25, m["x_var"])
    check("gibbs_user z freq", abs(m["z_freq"] - (1 - pi0)) <= 0.02,
          m["z_freq"])
    check("gibbs_user rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    check("gibbs_user cube equals the built-in's bit for bit", equal,
          "differs")
    k = phase_gibbs_kernel(g, 0x5EED_3333)
    m["err"] = k["err"]
    pos = g.state.positions
    hk = torch.empty((GIBBS_K,) + tuple(pos.shape), device=dev)
    args = (g.conditional, pos, 0x5EED_3434, 0, GIBBS_K)
    m.update(kernel_times(lambda: gibbs_multistep(*args, hk),
                          lambda: gibbs_multistep_plain(*args, hk),
                          "gibbs_multistep_kernel"))
    say("gibbs_user", chains=MH_CHAINS, K=GIBBS_K,
        **{k: repr(v) for k, v in m.items()})
    return m


def sep_run_gates(label: str, sample, elapsed: float, var_want: float,
                  scales=None) -> dict:
    """bench.py:635-640's gates on a separable stage's time-major cube
    (on z = x / s for ``scales``): the mean within 0.02 sd, the variance
    within 5%, R-hat and the ESS floor on its first SEP_DIAG_DIM
    coordinates."""
    z = sample if scales is None else sample.div_(scales)
    var, mean = torch.var_mean(z, correction=0)
    rhat, ess = mt.split_rhat_mean_ess(z[:, :, :SEP_DIAG_DIM].contiguous(),
                                       time_major=True)
    steps = 2 * sample.shape[0]
    m = {"elapsed_s": elapsed, "mean": float(mean), "var": float(var),
         "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
         "accept_rate": float((z[1:, :, 0] != z[:-1, :, 0]).float().mean()),
         "step_us": elapsed / steps * 1e6,
         "coordinate_updates_per_sec":
             steps * sample.shape[1] * sample.shape[2] / elapsed}
    sd = math.sqrt(var_want)
    check(f"{label} mean", abs(m["mean"]) < 0.02 * sd, m["mean"])
    check(f"{label} var", abs(m["var"] / var_want - 1.0) < 0.05, m["var"])
    check(f"{label} rhat", 0.95 <= m["rhat_mean"] <= 1.05, m["rhat_mean"])
    check(f"{label} ess floor",
          m["ess_mean"] >= 0.02 * sample.shape[1] * sample.shape[0],
          m["ess_mean"])
    return m


def sep_user_times(target, pos, logp, eps_value: float) -> dict:
    """A user instance's fused step at L = 10: ms by CUDA events, device
    ms alone, its twin's ms."""
    tables = sep_tables(target, pos)
    eps = torch.tensor([eps_value], device=pos.device)
    args = (target, pos, logp, eps, SEP_L, 0x5EED_7E7E, 3, tables)
    return kernel_times(lambda: hmc_separable_step(*args),
                        lambda: hmc_separable_step_plain(*args),
                        "hmc_separable_kernel")


def phase_sep_user(dev) -> dict:
    """``[sep_user]``: the separable stage of bench.py:553-660 (D =
    10,000, 1,024 chains, eps 0.1, L = 10, run(128, 128)) with
    ``standard_normal``'s density as a plain user Target (the coordinate
    functor generated from its batch form at D = 1) beside the built-in
    functor from the same seed and start: one counted run each (256
    fused launches, the user instance's), the four gates of
    bench.py:635-640 on the user cube, and the per-chain accept decisions
    of the two cubes the same on MH_SHARE of the chains. Then the logistic
    with scales s_d = logspace(-0.5, 0.5, D) (examples/user_forms.py:
    logistic) through the hand ``cuda_coord_source`` (its own grad) and
    the derived route (the tile form traced, Dual<1>): a counted
    run(128, 128) at eps 0.15 each, the gates on z = x / s (variance
    pi^2 / 3) and an acceptance in [0.6, 0.95]; each functor's fused step
    against its float32 and float64 twins (sep_step_check) and its
    trajectory (sep_kernel_check); then one step each of the hand
    logistic's Scaled (a diagonal metric) and TransformedCoord
    (interval(-24, 24)) instances against their twins, and every user
    instance's times."""
    from mini_mcmc_torch.examples import user_forms as F

    steps = 2 * SEP_COLLECT
    init = mt.init_with_seed(SEP_CHAINS, SEP_DIM, seed=2, device=dev)
    out, cubes = {}, {}
    for form, target in (("builtin", mt.standard_normal()),
                         ("traced", mt.models.Target(
                             logp=mt.standard_normal().logp))):
        h = mt.HMC(target, init, SEP_EPS, SEP_L,
                   use_pallas="separable").seed(2)
        user = steps if form == "traced" else 0
        sample, elapsed, counts = counted_run(
            f"sep_user {form}", h, (SEP_COLLECT, SEP_COLLECT),
            dict(hmc_separable_step=steps, hmc_separable_step_user=user))
        if form == "traced":
            m = sep_run_gates("sep_user traced", sample, elapsed, 1.0)
            m["launches"] = counts["hmc_separable_step_user"]
            err, _ = sep_step_check(h.kernel_target, h.state.positions,
                                    h.state.logp, SEP_EPS,
                                    "sep_user_traced_step")
            m["err"] = err
            m.update(sep_user_times(h.kernel_target, h.state.positions,
                                    h.state.logp, SEP_EPS))
            out["traced"] = m
        cubes[form] = sample
        del h
    agree = chain_decisions_agree(cubes["traced"][:, :, :1],
                                  cubes["builtin"][:, :, :1])
    out["traced"]["share_chains_decisions_builtin"] = float(
        agree.float().mean())
    del cubes
    torch.cuda.empty_cache()
    check("sep_user traced decisions agree with the built-in's",
          out["traced"]["share_chains_decisions_builtin"] >= MH_SHARE,
          out["traced"]["share_chains_decisions_builtin"])
    scales = logistic_scales(dev)
    for form, hand in (("logistic_hand", True), ("logistic_derived", False)):
        h = mt.HMC(F.logistic(scales, hand=hand), init, LOGISTIC_EPS, SEP_L,
                   use_pallas="separable").seed(4)
        sample, elapsed, counts = counted_run(
            f"sep_user {form}", h, (SEP_COLLECT, SEP_COLLECT),
            dict(hmc_separable_step=steps, hmc_separable_step_user=steps))
        m = sep_run_gates(f"sep_user {form}", sample, elapsed, LOGISTIC_VAR,
                          scales)
        m["launches"] = counts["hmc_separable_step_user"]
        del sample
        torch.cuda.empty_cache()
        check(f"sep_user {form} acceptance in [0.6, 0.95]",
              0.6 <= m["accept_rate"] <= 0.95, m["accept_rate"])
        kt, pos, logp = h.kernel_target, h.state.positions, h.state.logp
        sep_kernel_check(kt, pos, LOGISTIC_EPS, f"sep_user_{form}_kernel")
        m["err"], _ = sep_step_check(kt, pos, logp, LOGISTIC_EPS,
                                     f"sep_user_{form}_step")
        m.update(sep_user_times(kt, pos, logp, LOGISTIC_EPS))
        out[form] = m
        if hand:
            eq_pos = pos  # the hand logistic's equilibrium, in x
        del h
    for kind, wt in logistic_wrapped(dev).items():
        if kind == "scaled":  # y = x / s, the metric's scale
            pos = eq_pos / logistic_scales(dev).flip(0)
        else:
            pos = mt.CoordinateTransform(
                {i: mt.interval(-24.0, 24.0) for i in range(SEP_DIM)},
                dim=SEP_DIM).to_y(eq_pos.clamp(-23.0, 23.0))
        pos = pos.contiguous()
        logp = wt.batch_logp(pos).float()
        reset_counts()
        err, _ = sep_step_check(wt, pos, logp, LOGISTIC_EPS,
                                f"sep_user_logistic_{kind}_step")
        counts = read_counts()
        check(f"sep_user logistic {kind} runs its user instance",
              counts["hmc_separable_step_user"] > 0
              and counts[f"hmc_separable_step_{kind}"] > 0, counts)
        m = {"err": err, **sep_user_times(wt, pos, logp, LOGISTIC_EPS)}
        out[f"logistic_{kind}"] = m
    del eq_pos
    for form, m in out.items():
        say("sep_user", form=form, chains=SEP_CHAINS, D=SEP_DIM, L=SEP_L,
            **{k: repr(v) for k, v in m.items()})
    return out


def k5678_user_bounds() -> dict:
    """bound_ms and bound_by of each user instance of Kernels 5-8 at the
    shapes of its timing, by record name: the work of the function
    whatever the form (a hand source's operations, the least the function
    needs), as bounds() reckons the built-in instances'."""
    out = {}
    c = MH_CHAINS
    mh_bytes = 2 * c * (4 * 2 + 4) + MH_K * c * 4 * 2
    gauss = c * MH_K * (rng_ops(2, 1) + 2 * OPS["isotropic_propose"]
                        + OPS["gauss2d_logp"] + OPS["mh_step"])
    for name in ("mh_multistep_user_hand", "mh_multistep_user_traced",
                 "mh_multistep_user_proposal_isotropic",
                 "mh_multistep_user_proposal_scaled"):
        out[name] = bound(mh_bytes, gauss)
    out["mh_multistep_user_rosenbrock"] = bound(
        mh_bytes, c * MH_K * (rng_ops(2, 1) + 2 * OPS["isotropic_propose"]
                              + OPS["banana_logp"] + OPS["mh_step"]))
    # the Gaussians of standard deviations 0.5..2.5 at D = 5 and 16: D
    # reciprocals a chain once, then 2 D + 1 operations an evaluation
    for dim in MH_USER_DIMS:
        out[f"mh_multistep_user_d{dim}"] = bound(
            2 * c * (4 * dim + 4) + MH_K * c * 4 * dim,
            c * (dim * OPS["rcp"] + MH_K * (
                rng_ops(dim, 1) + dim * OPS["isotropic_propose"]
                + dim * OPS["gauss_coord_logp"] + 1 + OPS["mh_step"])))
    # Kernel 8 on bench's bimodal density at D = 1 (a mixture's work) and
    # the D = 5 Gaussian: T D normals and T + active pairs uniforms a step
    c, t = PT_CHAINS, PT_TEMPS

    def pt_bound(dim, logp_ops, once=0):
        ops = once
        for k in range(PT_K):
            active = len(range(k % 2, t - 1, 2))
            ops += (rng_ops(t * dim, t + active)
                    + t * (logp_ops + OPS["pt_update"]
                           + 2 * (dim - 1))
                    + active * OPS["pt_swap"])
        return bound(2 * 4 * c * (t * dim + t + t - 1) + PT_K * c * 4 * dim,
                     c * ops)

    out["pt_multistep_user_traced"] = pt_bound(1, OPS["mixture1d_logp"])
    out["pt_multistep_user_hand"] = out["pt_multistep_user_traced"]
    out["pt_multistep_user_d5"] = pt_bound(
        PT_USER_DIM, PT_USER_DIM * OPS["gauss_coord_logp"] + 1,
        PT_USER_DIM * OPS["rcp"])
    c = MH_CHAINS
    out["gibbs_multistep_user"] = bound(
        2 * c * 4 * 2 + GIBBS_K * c * 4 * 2,
        c * GIBBS_K * (rng_ops(1, 1) + OPS["mixture_sweep"]))
    c, d = SEP_CHAINS, SEP_DIM

    def sep_bound(leapfrog_ops, coord_ops, n_tables):
        return bound(4 * (2 * c * d + 3 * c + 1 + n_tables * d),
                     c * (d * (SEP_L * leapfrog_ops + coord_ops)
                          + rng_ops(d, 0) + rng_ops(0, 1)
                          + OPS["sep_accept"]))

    out["hmc_separable_user_traced"] = sep_bound(
        OPS["sep_leapfrog"], OPS["sep_coord"], 0)
    logistic = (OPS["sep_leapfrog"] + OPS["logistic_grad"],
                OPS["sep_coord"] + OPS["logistic_coef"]
                + OPS["logistic_logp"])
    out["hmc_separable_user_logistic_hand"] = sep_bound(*logistic, 1)
    out["hmc_separable_user_logistic_derived"] = out[
        "hmc_separable_user_logistic_hand"]
    # a diagonal metric's scale m folds into the coordinate's constant:
    # F(m y) has r m in place of r, one product a coordinate
    out["hmc_separable_user_logistic_scaled"] = sep_bound(
        logistic[0], logistic[1] + 1, 2)
    out["hmc_separable_user_logistic_transformed"] = sep_bound(
        logistic[0] + OPS["bij_grad_interval"],
        logistic[1] + OPS["bij_logp_interval"], 4)
    return out


def k5678_user_records(record, mhu: dict, mhp: dict, ptu: dict, gu: dict,
                       su: dict) -> tuple[list, list]:
    """The kernels line's records of the user instances of Kernels 5-8:
    those that ran on the user stages' counted runs (their launches a
    run, as their counted runs read them), and off those runs the kernel
    checks alone (Kernel 5 at D = 5 and 16, Kernel 8 at D = 5, Kernel 7's
    scaled and transformed logistic), launches 0. Returns (main-path
    records, off-path records)."""
    k5 = ("mh_multistep.cuh", "mh_full.py:50")
    k6 = ("gibbs_multistep.cuh", "gibbs_full.py:47")
    k7 = ("hmc_separable.cuh", "hmc_bigd.py:177")
    k8 = ("pt_multistep.cuh", "tempering_full.py:61")
    rows = [
        (k5, "mh_multistep_user_hand", mhu["hand"]),
        (k5, "mh_multistep_user_traced", mhu["traced"]),
        (k5, "mh_multistep_user_rosenbrock", mhu["rosenbrock"]),
        (k5, "mh_multistep_user_proposal_isotropic", mhp["isotropic"]),
        (k5, "mh_multistep_user_proposal_scaled", mhp["scaled"]),
        (k8, "pt_multistep_user_traced", ptu["traced"]),
        (k8, "pt_multistep_user_hand", ptu["hand"]),
        (k6, "gibbs_multistep_user", gu),
        (k7, "hmc_separable_user_traced", su["traced"]),
        (k7, "hmc_separable_user_logistic_hand", su["logistic_hand"]),
        (k7, "hmc_separable_user_logistic_derived", su["logistic_derived"]),
    ]
    off_rows = [
        *((k5, f"mh_multistep_user_d{d}", mhu[f"d{d}"])
          for d in MH_USER_DIMS),
        (k8, "pt_multistep_user_d5", ptu["d5"]),
        (k7, "hmc_separable_user_logistic_scaled", su["logistic_scaled"]),
        (k7, "hmc_separable_user_logistic_transformed",
         su["logistic_transformed"]),
    ]
    main = [record(name, src, rep, m["launches"], m["err"], m["ms"],
                   m["plain_ms"], device_ms=m["device_ms"])
            for (src, rep), name, m in rows]
    off = [record(name, src, rep, 0, m["err"], m["ms"], m["plain_ms"],
                  device_ms=m["device_ms"])
           for (src, rep), name, m in off_rows]
    return main, off

# ---------------------------------------------------------------------------
# 39: float64 states through Kernel 1, int32 user forms in Kernel 5

#: the FP64 rate the float64 instances are bound by: 64 FP64 lanes an SM,
#: half the FP32 issue rate above
FP64_PER_S = ISSUE_PER_S / 2
#: [f64_leapfrog]'s per-chain tolerance: relative to the row's largest
#: |entry| (a Rosenbrock gradient cancels near a component's zero). The
#: kernel contracts FMAs where the twin does not, some 1e-16 a step, which
#: a stable L = 8 trajectory grows nowhere near 1e-9
F64_RTOL = 1e-9
#: the share of chains [f64_leapfrog] holds to the float64 twin at L <= 8
F64_SHARE = 0.999
#: [f64_hmc_tier]'s burn-in and timed run, in draws (the flagship's 8,192
#: each cut to fit the budget; its gates' tolerances scaled by
#: sqrt(N_COLLECT / F64_HMC_RUN))
F64_HMC_RUN = 2048
#: [f64_hmc_tier]'s float32 run beside it and each profiled run, draws
F64_TIER_F32_RUN, F64_PROFILE_RUN = 512, 128
#: the chains of [f64_samplers]: tests/test_float64.py's 4 would fail
#: SGLD's mean gate (|mean| < 0.3) on ~27% of seeds on the port's Philox
#: stream (SGLD's decaying step mixes over ~250 steps: a 30-seed sweep on
#: the CPU); the card's job is many chains, at which the gates test what
#: they mean to
F64_SAMPLER_CHAINS = 4096
#: [f64_samplers]' mean gates at those chains: beside the test's own bound,
#: |mean - truth| within this many standard errors of the mean, the SE
#: from the spread of the per-chain means (the chains are independent), so
#: that a gate keeps its power at 4,096 chains (a 9-seed CPU sweep of the
#: five gated samplers: |z| <= 2.5)
F64_SAMPLER_SE = 5.0
#: the D of the user densities of [f64_leapfrog]
F64_USER_DIM = 5
#: [mh_user_int32]'s binomial
BINOM_N, BINOM_P = 10, 0.3
OPS.update({
    # Kernel 1 per leapfrog at D: the Rosenbrock gradient's 6 (D - 1) and
    # the kicks' and drift's 3 D (rosen3d_leapfrog at D = 3)
    "user_rosen5_leapfrog": 6 * 4 + 3 * 5,
    # the binomial's value, priced as the Poisson's: k lies in [0, n], so
    # a table read of log C(n, k), k log p + (n - k) log(1 - p) (a
    # subtraction and two FMAs), the k < 0 and k > n compares, their or
    # and the select (the traced source's two lgammaf, 27-54 SASS
    # instructions a lane each, are work the function does not need)
    "binomial_logp": 10,
})


def bound64(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """:func:`bound` of a float64 instance: its operations at the FP64
    rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP64_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def int32_forms() -> dict:
    """[mh_user_int32]'s three instances: the hand Poisson source (a copy
    of targets.cuh:Poisson) beside the built-in walk, the traced binomial
    beside the built-in walk reflected at 0 and n, and the built-in
    Poisson beside the user int walk (proposals.cuh:RandomWalkInt as a
    source)."""
    from mini_mcmc_torch.examples import user_forms as F

    return {
        "hand": (F.poisson_user(POISSON_LAM), mt.random_walk_int_proposal()),
        "traced": (mt.models.binomial_target(BINOM_N, BINOM_P),
                   mt.random_walk_int_proposal(0, BINOM_N)),
        "proposal": (mt.poisson_target(POISSON_LAM), F.int_walk()),
    }


def f64_int32_requests(dev) -> tuple[list, list]:
    """The libraries of phase 39, as ``user_density.Spec``: Kernel 1's
    float64 instance of the D = 5 user density, hand and traced (traced
    on the card at float64), and the int32 value-only libraries of
    :func:`int32_forms` (Kernel 5 and the probes)."""
    from mini_mcmc_torch.examples import user_forms as F

    f64 = [user_density.density_spec(F.rosenbrock_user(hand), F64_USER_DIM,
                                     dev, torch.float64)[0]
           for hand in (True, False)]
    i32 = [user_density.value_spec(t, q, 1, dev, torch.int32)[0]
           for t, q in int32_forms().values()]
    return f64, i32


def phase_f64_build(f64_reqs, reported: dict) -> dict:
    """``[f64_ptxas]``: the registers, stack frame and spills of every
    float64 instance of Kernel 1, the built-in library's (``reported``,
    phase_build's) and the user densities' float64 libraries, with their
    nvcc seconds. Spills are reported, not refused: a double Dual<5>
    gradient holds twice the registers of a float one."""
    out = {name: info for name, info in reported.items()
           if name.startswith("leapfrog_kernel") and name.endswith("Ed")}
    for spec in f64_reqs:
        so = user_density.library_path(*spec)
        log = so.with_suffix(".log").read_text()
        head = log.splitlines()[0]
        seconds = float(head.split()[-1]) if head.startswith(
            "build seconds") else float("nan")
        _, rep = ptxas_report(log)
        say("user_build", form=repr(f"density:{spec.types}:D={spec.dim}"),
            lib=so.name, nvcc_seconds=seconds, instances=len(rep))
        out.update({f"user:{so.stem}:{name}": info
                    for name, info in rep.items()})
    for name, info in out.items():
        say("f64_ptxas", kernel=name[:72], **info)
    # MM_DISPATCH_S at double: Rosenbrock and the funnel at D = 2-4, the
    # Gaussian at 2, each plain, whitened, transformed and both
    builtin = sum(not name.startswith("user:") for name in out)
    check("float64 Kernel 1 instances built", builtin == 28
          and len(out) == 28 + len(f64_reqs), (builtin, len(out)))
    return out


def f64_agree(k: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per chain: every entry within F64_RTOL of the row's largest |entry|
    of the twin, or non-finite in both."""
    k, p = k.reshape(k.shape[0], -1), p.reshape(p.shape[0], -1)
    scale = p.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    ok = (k - p).abs() <= F64_RTOL * scale
    ok |= ~torch.isfinite(k) & ~torch.isfinite(p)
    return ok.all(dim=1)


def f64_cases(dev) -> dict:
    """[f64_leapfrog]'s instances of Kernel 1 at float64, each on 65,536
    chains: ``name -> (target, positions, eps, L, leapfrog ops)``."""
    from mini_mcmc_torch.examples import user_forms as F

    gen = torch.Generator(device=dev).manual_seed(64)
    c = N_CHAINS

    def normal(d, scale, shift):
        return (torch.randn((c, d), generator=gen, device=dev,
                            dtype=torch.float64) * scale + shift)

    rosen = mt.rosenbrock_nd()
    x3 = normal(3, 0.3, 0.8)
    diag = mt.models.estimate_preconditioner(x3, "diag")
    tf = mt.CoordinateTransform({0: mt.positive()}, dim=2)
    gauss = mt.diffable_gaussian2d(MALA_MEAN, NUTS_COV)
    bij = OPS["bij_grad"] + OPS["bij_identity"]
    return {
        "flagship": (rosen, x3, STEP_SIZE, N_LEAPFROG,
                     OPS["rosen3d_leapfrog"]),
        "flagship_L8": (rosen, x3, STEP_SIZE, 8, OPS["rosen3d_leapfrog"]),
        "mala_d2": (gauss, normal(2, 1.5, 0.0), 1.0, 1,
                    OPS["gauss2d_leapfrog"]),
        "whitened_diag": (mt.models.precondition_target(rosen, diag),
                          diag.to_y(x3), STEP_SIZE, 8,
                          OPS["rosen3d_leapfrog"] + 2 * 3),
        "transformed": (tf.wrap(gauss), normal(2, 0.7, 0.0), 0.2, 8,
                        OPS["gauss2d_leapfrog"] + bij),
        "funnel_d4": (mt.neal_funnel(FUNNEL_SCALE), normal(4, 0.8, 0.0),
                      0.1, 8, OPS["funnel4_grad"] + OPS["funnel4_leapfrog"]),
        "user_hand_d5": (F.rosenbrock_user(True),
                         normal(F64_USER_DIM, 0.3, 0.8), 0.01, 8,
                         OPS["user_rosen5_leapfrog"]),
        "user_traced_d5": (F.rosenbrock_user(False),
                           normal(F64_USER_DIM, 0.3, 0.8), 0.01, 8,
                           OPS["user_rosen5_leapfrog"]),
    }


def phase_f64_leapfrog(dev) -> dict:
    """``[f64_leapfrog]``: Kernel 1's float64 instances against the
    float64 twin per chain (F64_RTOL) on each of :func:`f64_cases`, the
    same momenta, and the float32 instance on the same case rounded to
    float32 beside it (the built-in functors'): the share of chains that
    agree, the largest error
    relative to the row, the device time alone, the time by events, the
    twin's time, and the bound at the FP64 rate. Gated at L <= 8 (99.9% of
    chains); at the flagship's L = 192 the share is reported, as
    phase_leapfrog reports its float32 one (a trajectory near the
    leapfrog stability edge grows any rounding difference)."""
    gen = torch.Generator(device=dev).manual_seed(65)
    out = {}
    for name, (target, x, eps, n_lf, lf_ops) in f64_cases(dev).items():
        c, d = x.shape
        mom = torch.randn(x.shape, generator=gen, device=dev,
                          dtype=torch.float64)
        _, g = target.batch_logp_and_grad(x)
        e = torch.tensor([eps], device=dev, dtype=torch.float64)
        reset_counts()
        k = leapfrog_trajectory(target, x, mom, g, e, n_lf)
        counts = read_counts()
        check(f"f64_leapfrog {name} launched the float64 instance",
              counts == counts_with(
                  leapfrog_trajectory=1, leapfrog_trajectory_f64=1,
                  leapfrog_trajectory_transformed=int(
                      target.cuda_transform is not None),
                  leapfrog_trajectory_user=int(target.cuda_functor is None)),
              counts)
        check(f"f64_leapfrog {name} float64 outputs",
              all(v.dtype == torch.float64 for v in k), [v.dtype for v in k])
        p = leapfrog_trajectory_plain(target, x, mom, g, e[0], n_lf)
        agree = torch.stack([f64_agree(a, b) for a, b in zip(k, p)]).all(0)
        finite = torch.stack([torch.isfinite(b.reshape(c, -1)).all(1)
                              for b in p]).all(0)
        ok = agree & finite
        rel = max(float(((a - b).reshape(c, -1).abs() / b.reshape(
            c, -1).abs().amax(1, keepdim=True).clamp(min=1e-300))[
                ok].max()) for a, b in zip(k, p))
        m = {"chains": c, "D": d, "L": n_lf,
             "share": float(agree.float().mean()),
             "share_twin_finite": float(finite.float().mean()),
             "max_rel_err": rel,
             "max_abs_err": max(max_abs_err(a, b, ok)
                                for a, b in zip(k, p))}
        f32 = (x.float(), mom.float(), g.float(), e.float())
        m.update(kernel_times(
            lambda: leapfrog_trajectory(target, x, mom, g, e, n_lf),
            lambda: leapfrog_trajectory_plain(target, x, mom, g, e[0], n_lf),
            "leapfrog_kernel"))
        m["ms_f32"] = m["device_ms_f32"] = m["device_ratio_f64_f32"] = None
        if target.cuda_functor is not None:  # a user density's float32
            # library is not in this phase's build
            m["ms_f32"] = cuda_ms(lambda: leapfrog_trajectory(
                target, *f32[:3], f32[3], n_lf), 20)
            m["device_ms_f32"] = device_ms_per_launch(
                lambda: leapfrog_trajectory(target, *f32[:3], f32[3], n_lf),
                "leapfrog_kernel")
            if None not in (m["device_ms"], m["device_ms_f32"]):
                m["device_ratio_f64_f32"] = (m["device_ms"]
                                             / m["device_ms_f32"])
        # pos, mom, grad, eps in; pos, mom, logp, grad out; the wrappers'
        # tables and params are a few doubles
        m["bound_ms"], m["bound_by"] = bound64(
            8 * (3 * c * d + 1 + c * (3 * d + 1)), c * n_lf * lf_ops)
        m["bound_ms_f32"] = bound(4 * (3 * c * d + 1 + c * (3 * d + 1)),
                                  c * n_lf * lf_ops)[0]
        say("f64_leapfrog", case=name, **{k2: repr(v) for k2, v in
                                          m.items()})
        if n_lf <= 8:
            check(f"f64_leapfrog {name} agrees with its float64 twin",
                  m["share"] >= F64_SHARE, m)
        out[name] = m
        del k, p
    return out



def phase_f64_hmc_tier(dev) -> dict:
    """``[f64_hmc_tier]``: the flagship's target, start and step through
    ``HMC(rosenbrock_nd(), float64 init, STEP_SIZE, N_LEAPFROG,
    use_pallas=True, jitter=0.3)`` on 65,536 chains: a burn-in run and a
    timed run of F64_HMC_RUN draws each, every step one launch of Kernel
    1's float64 instance and no plain twin; the cube, state, logp and
    gradient float64; the x0 moments against quadrature (bench.py:88-92)
    within the flagship's tolerances scaled by sqrt(N_COLLECT /
    F64_HMC_RUN), R-hat; draws/s and ESS/s. Beside it the same tier at
    float32 (a timed ``run(F64_TIER_F32_RUN)`` from the float64 end state,
    rounded) and the device's idle share over a profiled
    ``run(F64_PROFILE_RUN)`` of each: what the float64 step costs over
    the float32 one, and where."""
    init = (mt.init_with_seed(N_CHAINS, DIM, seed=42, device=dev) * 0.5
            + 1.0).double()
    reset_counts()
    h = mt.HMC(mt.rosenbrock_nd(), init, STEP_SIZE, N_LEAPFROG,
               use_pallas=True, jitter=JITTER).seed(42)
    burn = h.run(F64_HMC_RUN, 0, time_major=True)
    torch.cuda.synchronize()
    del burn
    t0 = time.perf_counter()
    sample = h.run(F64_HMC_RUN, 0, time_major=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    check("f64_hmc_tier launches: the float64 instance, no twin",
          counts == counts_with(leapfrog_trajectory=2 * F64_HMC_RUN,
                                leapfrog_trajectory_f64=2 * F64_HMC_RUN),
          counts)
    s = h.state
    check("f64_hmc_tier float64 cube and state",
          sample.dtype == torch.float64 and all(
              v.dtype == torch.float64 for v in s), (sample.dtype, [
                  v.dtype for v in s]))
    check("f64_hmc_tier sample", tuple(sample.shape) == (
        F64_HMC_RUN, N_CHAINS, DIM) and bool(torch.isfinite(sample).all()),
        tuple(sample.shape))
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    x0 = sample[:, :, 0]
    scale = math.sqrt(N_COLLECT / F64_HMC_RUN)
    m = {"elapsed_s": elapsed, "rhat_mean": float(rhat.mean()),
         "ess_mean": float(ess.mean()), "x0_mean": float(x0.mean()),
         "x0_var": float(x0.var(unbiased=False)),
         "tol_mean": 0.05 * scale, "tol_var": 0.04 * scale,
         "accept_rate": float((sample[1:] != sample[:-1]).any(dim=2)
                              .float().mean()),
         "draws_per_sec": N_CHAINS * F64_HMC_RUN / elapsed,
         "step_us": elapsed / F64_HMC_RUN * 1e6}
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    del sample, x0
    h32 = mt.HMC(mt.rosenbrock_nd(), h.positions.float(), STEP_SIZE,
                 N_LEAPFROG, use_pallas=True, jitter=JITTER).seed(43)
    h32.run(F64_PROFILE_RUN, 0)
    _, seconds = timed(lambda: h32.run(F64_TIER_F32_RUN, 0))
    m["step_us_f32"] = seconds / F64_TIER_F32_RUN * 1e6
    m["idle_share"] = idle_share(lambda: h.run(F64_PROFILE_RUN, 0))[
        "idle_share"]
    m["idle_share_f32"] = idle_share(lambda: h32.run(F64_PROFILE_RUN, 0))[
        "idle_share"]
    del h32
    check("f64_hmc_tier rhat", 0.95 <= m["rhat_mean"] <= 1.05, m)
    check("f64_hmc_tier x0 mean",
          abs(m["x0_mean"] - ROSEN3D_X0_MEAN) <= m["tol_mean"], m)
    check("f64_hmc_tier x0 var",
          abs(m["x0_var"] - ROSEN3D_X0_VAR) <= m["tol_var"], m)
    say("f64_hmc_tier", **{k: repr(v) for k, v in m.items()}, **counts)
    m["launches"] = counts["leapfrog_trajectory_f64"]
    return m


def phase_f64_mala_tuned(dev) -> dict:
    """``[f64_mala_tuned]``: the tuned-MALA stage of bench.py:732-779 at
    float64 on the ``use_pallas=True`` tier: ``MALA(diffable_gaussian2d,
    float64 init, step_size=1.0, use_pallas=True).seed(13)
    .tuned(MALA_ADAPT)`` (the dual-averaging iterate float64), then
    ``run(MALA_COLLECT, 0)`` twice, every step Kernel 1's float64 instance
    at L = 1 and no twin; bench.py:757-766's gates on the timed run."""
    target = mt.diffable_gaussian2d(MALA_MEAN, NUTS_COV)
    init = mt.init_with_seed(MALA_CHAINS, 2, seed=13, device=dev).double()
    reset_counts()
    t0 = time.perf_counter()
    ml = mt.MALA(target, init, step_size=1.0,
                 use_pallas=True).seed(13).tuned(MALA_ADAPT)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    sample, elapsed = timed_run(ml, MALA_COLLECT, 0, time_major=True)
    counts = read_counts()
    n = MALA_ADAPT + 2 * MALA_COLLECT
    check("f64_mala launches: the float64 instance, no twin",
          counts == counts_with(leapfrog_trajectory=n,
                                leapfrog_trajectory_f64=n), counts)
    check("f64_mala float64 cube and state", sample.dtype == torch.float64
          and ml.state.positions.dtype == torch.float64, sample.dtype)
    rhat, ess = mt.split_rhat_mean_ess(sample, time_major=True)
    var, mean = torch.var_mean(sample, dim=(0, 1), correction=0)
    total = MALA_CHAINS * MALA_COLLECT
    m = {"eps_tuned": ml.step_size, "tune_s": tune_s, "elapsed_s": elapsed,
         "rhat_mean": float(rhat.mean()), "ess_mean": float(ess.mean()),
         "mean": [float(v) for v in mean], "var": [float(v) for v in var],
         "accept_rate": float((sample[1:] != sample[:-1]).any(dim=2)
                              .float().mean())}
    del sample
    check("f64_mala tuned eps sane", 0.2 <= m["eps_tuned"] <= 5.0, m)
    check("f64_mala rhat", 0.95 <= m["rhat_mean"] <= 1.05, m)
    check("f64_mala ess floor", m["ess_mean"] >= 0.005 * total, m)
    for d in range(2):
        check(f"f64_mala mean[{d}]",
              abs(m["mean"][d] - MALA_MEAN[d]) <= 0.05, m)
        check(f"f64_mala var[{d}]", abs(m["var"][d] - MALA_VAR[d]) <= 0.3, m)
    m["ess_per_sec"] = m["ess_mean"] / elapsed
    m["draws_per_sec"] = total / elapsed
    m["step_us"] = elapsed / MALA_COLLECT * 1e6
    m["launches"] = counts["leapfrog_trajectory_f64"]
    say("f64_mala_tuned", **{k: repr(v) for k, v in m.items()}, **counts)
    return m


def phase_f64_samplers(dev) -> None:
    """``[f64_samplers]``: tests/test_float64.py:26-78 on the card at
    float64, each sampler on its plain tier (no kernel launched): MH,
    HMC, tuned MALA, slice, elliptical, SGLD and SGHMC, that test's steps,
    dtype asserts and gates, from F64_SAMPLER_CHAINS chains
    (``init_with_seed``) where the test starts 4 (``init_det``); each mean
    gate also within F64_SAMPLER_SE standard errors."""
    from mini_mcmc_torch.ops.sgmcmc import target_grad

    def init(d):
        return mt.init_with_seed(F64_SAMPLER_CHAINS, d, seed=d,
                                 device=dev).double()

    t = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    g = target_grad(t)
    lik = mt.models.Target(
        logp=lambda x: -0.5 * torch.sum((x - 1.0) ** 2, dim=-1))
    def mean_gate(truth, bound):
        """tests/test_float64.py's |mean - truth| < bound, and within
        F64_SAMPLER_SE standard errors of the per-chain means."""
        def gate(s):
            chain = s.reshape(s.shape[0], -1).mean(dim=1)
            se = float(chain.std()) / math.sqrt(chain.numel())
            err = abs(float(s.mean()) - truth)
            return err < bound and err <= F64_SAMPLER_SE * se, err / se
        return gate

    def finite(s):
        return math.isfinite(float(s.mean())), None

    runs = {
        "mh": (lambda: mt.MetropolisHastings(
            t, mt.isotropic_gaussian_proposal(1.0), init(2)
        ).seed(42).run(500, 100), mean_gate(0.0, 0.3)),
        "hmc": (lambda: mt.HMC(mt.rosenbrock_nd(), init(3),
                               0.05, 8).seed(1).run(200, 100),
                lambda s: (bool(torch.isfinite(
                    mt.split_rhat_mean_ess(s)[0]).all()), None)),
        "mala_tuned": (lambda: mt.MALA(
            mt.rosenbrock_nd(), init(3), step_size=0.5
        ).seed(4).tuned(100).run(200, 50), finite),
        "slice": (lambda: mt.SliceSampler(t, init(2))
                  .seed(2).run(300, 50), mean_gate(0.0, 0.3)),
        "elliptical": (lambda: mt.EllipticalSliceSampler(
            lik, init(2)).seed(3).run(300, 50), mean_gate(0.5, 0.25)),
        "sgld": (lambda: mt.SGLD(
            g, init(2),
            step_size=mt.polynomial_decay(5e-2, 10.0, 0.55)).seed(5).run(
                300, 100), mean_gate(0.0, 0.3)),
        "sghmc": (lambda: mt.SGHMC(g, init(2),
                                   step_size=0.05, friction=0.1).seed(6).run(
            300, 100), mean_gate(0.0, 0.35)),
    }
    for name, (run, gate) in runs.items():
        reset_counts()
        (s, seconds) = timed(run)
        check_no_kernel(f"f64_samplers {name}")
        check(f"f64_samplers {name} float64", s.dtype == torch.float64,
              s.dtype)
        ok, z = gate(s)
        check(f"f64_samplers {name} gate", ok, (float(s.mean()), z))
        say("f64_samplers", sampler=name, shape=tuple(s.shape),
            mean=float(s.mean()), se_z=z, seconds=seconds,
            device=str(s.device))


def phase_mh_user_int32(dev) -> dict:
    """``[mh_user_int32]``: the Poisson stage of bench.py:495-525 (65,536
    chains from 0, K = 10, ``run(200, 100)``) through Kernel 5's int32
    user instances (:func:`int32_forms`), each a warm-up run and a
    counted, timed run (the user instance's 30 launches a run, no twin),
    beside the built-in Poisson from the same seed: the hand Poisson's
    cube and the user walk's each the built-in's bit for bit, the pmf
    gate (< 0.05, tests/test_mh.py:73-90) on each, the binomial from 5;
    then one K-block of each against mh_multistep_plain per chain
    (phase_mh_kernel: int32 positions equal), and each block's device
    time alone, time by events and twin time."""
    per_run = (POISSON_COLLECT + POISSON_DISCARD) // POISSON_K
    run = (POISSON_COLLECT, POISSON_DISCARD)
    cubes, out = {}, {}
    k = torch.arange(11, dtype=torch.float64, device=dev)
    pmfs = {
        "poisson": torch.exp(k * math.log(POISSON_LAM) - POISSON_LAM
                             - torch.lgamma(k + 1.0)),
        "binomial": torch.exp(
            torch.lgamma(torch.tensor(BINOM_N + 1.0, device=dev))
            - torch.lgamma(k + 1.0) - torch.lgamma(BINOM_N - k + 1.0)
            + k * math.log(BINOM_P) + (BINOM_N - k) * math.log1p(-BINOM_P)),
    }
    forms = {"builtin": (mt.poisson_target(POISSON_LAM),
                         mt.random_walk_int_proposal()), **int32_forms()}
    for form, (target, proposal) in forms.items():
        start = 5 if form == "traced" else 0
        init = torch.full((MH_CHAINS, 1), start, dtype=torch.int32,
                          device=dev)
        mh = mt.MetropolisHastings(target, proposal, init, use_pallas="full",
                                   steps_per_call=POISSON_K).seed(42)
        user = per_run if form != "builtin" else 0
        sample, elapsed, counts = counted_run(
            f"mh_user_int32 {form}", mh, run,
            dict(mh_multistep=per_run, mh_multistep_user=user),
            time_major=False)
        check(f"mh_user_int32 {form} int32", sample.dtype == torch.int32
              and mh.state.logp.dtype == torch.float32, sample.dtype)
        ks = sample.reshape(-1).long()
        freq = torch.bincount(ks.clamp(min=0), minlength=11)[:11].double()
        pmf = pmfs["binomial" if form == "traced" else "poisson"]
        m = {"elapsed_s": elapsed, "launches": counts["mh_multistep_user"],
             "pmf_max_abs_err": float((freq / ks.numel() - pmf).abs().max()),
             "min": int(ks.min()), "max": int(ks.max()),
             "draws_per_sec": MH_CHAINS * sum(run) / elapsed}
        check(f"mh_user_int32 {form} support", m["min"] >= 0 and (
            form != "traced" or m["max"] <= BINOM_N), m)
        check(f"mh_user_int32 {form} pmf", m["pmf_max_abs_err"] < 0.05, m)
        if form != "builtin":
            m.update(phase_mh_kernel(mh, f"int32_{form}", POISSON_K,
                                     0x5EED_3232))
        cubes[form] = sample
        out[form] = m
        del mh
    for form in ("hand", "proposal"):
        out[form]["cube_equal_builtin"] = bool(torch.equal(
            cubes[form], cubes["builtin"]))
        check(f"mh_user_int32 {form} cube equals the built-in's bit for bit",
              out[form]["cube_equal_builtin"], "differs")
    del cubes
    for form, m in out.items():
        say("mh_user_int32", form=form, chains=MH_CHAINS, K=POISSON_K,
            **{k2: repr(v) for k2, v in m.items()})
    return out


def f64_int32_records(record, f64: dict, hmc64: dict, mala64: dict,
                      ptx64: dict, i32: dict) -> list:
    """The kernels line's records of phase 39: Kernel 1's float64
    instances (the flagship case's numbers, every case's beside them, the
    launches of [f64_hmc_tier] and of the MALA path) and Kernel 5's int32
    user instances (each counted run's launches)."""
    fl, gated = f64["flagship"], f64["flagship_L8"]
    more = {}
    for case, m in f64.items():
        for key in ("ms", "device_ms", "plain_ms", "bound_ms", "share",
                    "max_rel_err", "max_abs_err", "ms_f32", "device_ms_f32",
                    "device_ratio_f64_f32", "bound_ms_f32"):
            more[f"{key}_{case}"] = m[key]
    worst = max(ptx64.values(), key=lambda i: (i.get("spill_stores", 0),
                                               i["regs"]))
    # the error: the flagship state's L = 8 check (the gated one; at L =
    # 192 unstable chains grow any rounding without bound)
    recs = [record("leapfrog_trajectory_f64", "hmc_leapfrog.cu", "hmc.py:46",
                   hmc64["launches"], gated["max_abs_err"], fl["ms"],
                   fl["plain_ms"], device_ms=fl["device_ms"],
                   launches_mala_path=mala64["launches"],
                   instances=len(ptx64), worst_ptxas=worst, **more)]
    for form in ("hand", "traced", "proposal"):
        m = i32[form]
        recs.append(record(f"mh_multistep_user_int32_{form}",
                           "mh_multistep.cu", "mh_full.py:50", m["launches"],
                           m["err"], m["ms"], m["plain_ms"],
                           device_ms=m["device_ms"]))
    return recs


def bounds(step_details, subtree_leaves, dense_details, k1234t,
           funnel) -> dict:
    """bound_ms and bound_by of each kernel at the shapes of its timing."""
    c, d = N_CHAINS, DIM
    k, L = STEPS_PER_CALL, N_LEAPFROG
    hmc_step_ops = (L * OPS["rosen3d_leapfrog"] + rng_ops(d, 1)
                    + OPS["hmc_step"])
    out = {
        # Kernel 2: pos, logp, grad, eps in; pos, logp, grad, history out
        "hmc_multistep": bound(
            4 * (c * (2 * d + 1) * 2 + k + k * c * d),
            c * k * hmc_step_ops),
        # Kernel 1: pos, mom, grad, eps in; pos, mom, logp, grad out
        "leapfrog_trajectory": bound(
            4 * (3 * c * d + 1 + c * (3 * d + 1)),
            c * L * OPS["rosen3d_leapfrog"]),
        # their whitened instances (a metric) at the same shapes: the
        # affine map in every gradient and logp, L's triangle in
        "hmc_multistep_whitened": bound(
            4 * (c * (2 * d + 1) * 2 + k + k * c * d + d * (d + 1) // 2),
            c * k * (hmc_step_ops + (L + 1) * OPS["affine_d3"])),
        "leapfrog_trajectory_whitened": bound(
            4 * (3 * c * d + 1 + c * (3 * d + 1) + d * (d + 1) // 2),
            c * L * (OPS["rosen3d_leapfrog"] + OPS["affine_d3"])),
    }
    # Kernel 0 alone (philox_fill, as timed): four words out per counter
    n = N_CHAINS * (DIM + 1)
    out["philox_fill"] = bound(4 * 4 * n, n * OPS["philox_draw"])
    # Kernel 4: pos, eps in; pos and four [C] outputs out. The work is
    # this step's: the leaves each chain integrated, its merges (about
    # leaves - doublings) and doublings; per chain two momentum normals
    # and a uniform each for the slice, every merge and (two) every
    # doubling. The whitened instance adds the affine map to every
    # density evaluation (the start's and each leaf's)
    nc = NUTS_CHAINS

    def nuts_step_bound(details, affine_ops=0):
        leaves_c = details["leaves"].double()
        depth_c = details["depth"].double()
        merges_c = (leaves_c - depth_c).clamp(min=0.0)
        return bound(
            4 * (nc * 2 + nc + nc * 2 + 4 * nc),
            nc * (OPS["nuts_step"] + affine_ops)
            + float(rng_ops(2, 1 + 2 * depth_c + merges_c).sum())
            + float(leaves_c.sum()) * (OPS["nuts_leaf"] + affine_ops)
            + float(merges_c.sum()) * OPS["nuts_merge"]
            + float(depth_c.sum()) * OPS["nuts_doubling"])

    out["nuts_step"] = nuts_step_bound(step_details)
    out["nuts_step_dense_metric"] = nuts_step_bound(
        dense_details, OPS["affine_d2"])
    # the transformed instances: a density evaluation adds the bijector of
    # x0 and the identity's compare of x1 (and the metric's map)
    bij = OPS["bij_grad"] + OPS["bij_identity"]
    out["nuts_step_transformed"] = nuts_step_bound(k1234t["details"], bij)
    out["nuts_step_whitened_transformed"] = nuts_step_bound(
        k1234t["whitened_details"], bij + OPS["affine_d2"])
    # Kernel 3 at each j of phase_subtree (the record's own at j = 4): pos,
    # mom, grad, logu, v, eps, joint0, active in; five [C, 2] and six [C]
    # outputs. The work is that j's leaves and about one merge per leaf
    # past each chain's first
    for j, done in subtree_leaves.items():
        sub = float(done.double().sum())
        out[f"nuts_subtree_j{j}"] = bound(
            nc * (4 * (3 * 2 + 4) + 1) + nc * (4 * 5 * 2 + 4 * 4 + 2),
            nc * OPS["nuts_step"] + sub * OPS["nuts_leaf"]
            + max(sub - nc, 0.0) * (OPS["nuts_merge"] + OPS["hash_draw"]))
    out["nuts_subtree"] = out["nuts_subtree_j4"]
    sub = float(k1234t["subtree_leaves"][4].double().sum())
    out["nuts_subtree_transformed"] = bound(
        nc * (4 * (3 * 2 + 4) + 1) + nc * (4 * 5 * 2 + 4 * 4 + 2),
        nc * OPS["nuts_step"] + sub * (OPS["nuts_leaf"] + bij)
        + max(sub - nc, 0.0) * (OPS["nuts_merge"] + OPS["hash_draw"]))
    # Kernels 1 and 2's transformed instances on all the constrained
    # stage's chains (D = 2): Kernel 1 at L = 192, Kernel 2 at K = 16, L = 8
    d = 2
    out["leapfrog_trajectory_transformed"] = bound(
        4 * (3 * nc * d + 1 + nc * (3 * d + 1)),
        nc * N_LEAPFROG * (OPS["gauss2d_leapfrog"] + bij))
    out["hmc_multistep_transformed"] = bound(
        4 * (nc * (2 * d + 1) * 2 + STEPS_PER_CALL
             + STEPS_PER_CALL * nc * d),
        nc * STEPS_PER_CALL * (8 * (OPS["gauss2d_leapfrog"] + bij)
                               + rng_ops(d, 1) + OPS["hmc_step"]
                               + OPS["bij_logp"]))
    # the funnel at D = 4 (Kernel 4 one step, Kernel 3 at j = 3): a leaf's
    # density is the funnel's gradient, four coordinates' kicks and drifts
    # in place of the two of the Gaussian's
    fc, fd = FUNNEL_CHAINS, FUNNEL_DIM
    funnel_leaf = (OPS["nuts_leaf"] - OPS["gauss2d_leapfrog"]
                   + OPS["funnel4_grad"] + OPS["funnel4_leapfrog"])
    leaves_c = funnel["details"]["leaves"].double()
    depth_c = funnel["details"]["depth"].double()
    merges_c = (leaves_c - depth_c).clamp(min=0.0)
    out["nuts_step_funnel"] = bound(
        4 * (fc * fd * 2 + fc + 4 * fc),
        fc * OPS["nuts_step"]
        + float(rng_ops(fd, 1 + 2 * depth_c + merges_c).sum())
        + float(leaves_c.sum()) * funnel_leaf
        + float(merges_c.sum()) * OPS["nuts_merge"]
        + float(depth_c.sum()) * OPS["nuts_doubling"])
    sub = float(funnel["subtree_leaves"][3].double().sum())
    out["nuts_subtree_funnel"] = bound(
        fc * (4 * (3 * fd + 4) + 1) + fc * (4 * 5 * fd + 4 * 4 + 2),
        fc * OPS["nuts_step"] + sub * funnel_leaf
        + max(sub - fc, 0.0) * (OPS["nuts_merge"] + OPS["hash_draw"]))
    # Kernel 5, one K-step block: pos and logp in and out, K history rows.
    # A step draws D proposal normals (Gaussian2D) or D coins (Poisson)
    # and the accept uniform
    c = MH_CHAINS
    out["mh_multistep_gauss2d"] = bound(
        2 * c * (4 * 2 + 4) + MH_K * c * 4 * 2,
        c * MH_K * (rng_ops(2, 1) + 2 * OPS["isotropic_propose"]
                    + OPS["gauss2d_logp"] + OPS["mh_step"]))
    out["mh_multistep_poisson"] = bound(
        2 * c * (4 + 4) + POISSON_K * c * 4,
        c * POISSON_K * (rng_ops(0, 2) + OPS["int_walk_propose"]
                         + OPS["poisson_logp"] + OPS["mh_step"]))
    # the int32 user instances: the Poisson's work (hand density, user
    # walk), the binomial's value in place of the Poisson's
    out["mh_multistep_user_int32_hand"] = out["mh_multistep_poisson"]
    out["mh_multistep_user_int32_proposal"] = out["mh_multistep_poisson"]
    out["mh_multistep_user_int32_traced"] = bound(
        2 * c * (4 + 4) + POISSON_K * c * 4,
        c * POISSON_K * (rng_ops(0, 2) + OPS["int_walk_propose"]
                         + OPS["binomial_logp"] + OPS["mh_step"]))
    # Kernel 6, one K-sweep block: pos in and out, K history rows. A
    # mixture sweep draws a normal (x) and a uniform (z)
    out["gibbs_multistep"] = bound(
        2 * c * 4 * 2 + GIBBS_K * c * 4 * 2,
        c * GIBBS_K * (rng_ops(1, 1) + OPS["mixture_sweep"]))
    # Kernel 7, one step. The fused step: pos and logp in; the new
    # positions, logp and alpha_c out; the trajectory-only form: pos in,
    # the proposal and three [C] partials out. Per coordinate L leapfrogs,
    # the sums (and the select), and its momentum normal; the fused step
    # adds per chain the accept uniform and the accept
    c, d = SEP_CHAINS, SEP_DIM

    def sep_bound(n_leapfrog, leapfrog_ops, coord_ops, n_tables, fused):
        return bound(
            4 * (2 * c * d + 3 * c + 1 + n_tables * d),
            c * (d * (n_leapfrog * leapfrog_ops + coord_ops) + rng_ops(d, 0)
                 + (rng_ops(0, 1) + OPS["sep_accept"] if fused else 0)))

    for suffix, fused in (("", True), ("_trajectory", False)):
        out["hmc_separable" + suffix] = sep_bound(
            SEP_L, OPS["sep_leapfrog"], OPS["sep_coord"], 0, fused)
        out["hmc_separable_L40" + suffix] = sep_bound(
            SEP_L40, OPS["sep_leapfrog"], OPS["sep_coord"], 0, fused)
        # the scaled instance on the sigma table: two [D] tables more in,
        # and per coordinate the (s / sigma)^2 coefficient once and its
        # product in every leapfrog's gradient
        out["hmc_separable_scaled" + suffix] = sep_bound(
            SEP_L, OPS["sep_leapfrog_scaled"],
            OPS["sep_coord"] + OPS["sep_scaled_coef"], 2, fused)
    # the transformed instances: every coordinate's bijector in each
    # gradient and in the density, its [3, D] table in. The constrained
    # stage's step (positive() everywhere, L = 8); the mixed table's (four
    # constrained blocks in five, L = 10); under a diag metric two more
    # products a leapfrog and the scale's table
    out["hmc_separable_transformed"] = sep_bound(
        SEP_C_L, OPS["sep_leapfrog"] + OPS["bij_grad"],
        OPS["sep_coord"] + OPS["bij_logp"], 3, True)
    mixed_grad = 0.8 * OPS["bij_grad"] + 0.2 * OPS["bij_identity"]
    mixed_logp = 0.8 * OPS["bij_logp"] + 0.2 * OPS["bij_identity"]
    out["hmc_separable_mixed"] = sep_bound(
        SEP_L, OPS["sep_leapfrog"] + mixed_grad,
        OPS["sep_coord"] + mixed_logp, 3, True)
    out["hmc_separable_scaled_transformed"] = sep_bound(
        SEP_L, OPS["sep_leapfrog"] + 2 + mixed_grad,
        OPS["sep_coord"] + mixed_logp, 4, True)
    # Kernel 2 at L = 1 on the MALA stage (Gaussian2D, 65,536 chains):
    # pos, logp, grad, eps in; pos, logp, grad, history out; Kernel 1 at
    # L = 1 there (the tuning path)
    c, d, k = MALA_CHAINS, 2, MALA_K
    out["hmc_multistep_mala"] = bound(
        4 * (c * (2 * d + 1) * 2 + k + k * c * d),
        c * k * (OPS["gauss2d_leapfrog"] + rng_ops(d, 1) + OPS["hmc_step"]))
    out["leapfrog_trajectory_mala"] = bound(
        4 * (3 * c * d + 1 + c * (3 * d + 1)), c * OPS["gauss2d_leapfrog"])
    # Kernel 5 at the tuned scale: the Gaussian2D block's work
    out["mh_multistep_tuned"] = out["mh_multistep_gauss2d"]
    # Kernel 8, one K-step block from parity 0 at T rungs, D = 1: pos,
    # logp and the swap EWMA in and out, K history rows. A step draws a
    # proposal normal and an accept uniform per rung and a uniform per
    # active swap pair (pairs t = parity, parity + 2, ...)
    c, t = PT_CHAINS, PT_TEMPS
    ops = 0.0
    for k in range(PT_K):
        active = len(range(k % 2, t - 1, 2))
        ops += (rng_ops(t, t + active)
                + t * (OPS["mixture1d_logp"] + OPS["pt_update"])
                + active * OPS["pt_swap"])
    out["pt_multistep"] = bound(
        2 * 4 * c * (t + t + t - 1) + PT_K * c * 4, c * ops)
    # the transformed instances of Kernels 5 and 8 (transform=): the same
    # bytes (the bijector table is a few floats), and every density adds
    # its coordinates' bijectors: x0's positive() and x1's identity on the
    # MH stage, interval(-24, 24) on each rung's density
    c = MH_CHAINS
    out["mh_multistep_transformed"] = bound(
        2 * c * (4 * 2 + 4) + MH_K * c * 4 * 2,
        c * MH_K * (rng_ops(2, 1) + 2 * OPS["isotropic_propose"]
                    + OPS["gauss2d_logp"] + OPS["mh_step"]
                    + OPS["bij_logp"] + OPS["bij_identity"]))
    c = PT_CHAINS
    out["pt_multistep_transformed"] = bound(
        2 * 4 * c * (t + t + t - 1) + PT_K * c * 4,
        c * (ops + PT_K * t * OPS["bij_logp_interval"]))
    return out


#: the port's examples, in the order the [examples] phase drives them
EXAMPLES = ("minimal_mh", "gauss_mh", "rosenbrock_mh", "mixture_gibbs",
            "minimal_hmc", "rosenbrock3d_hmc", "minimal_nuts", "metric_nuts",
            "logistic_regression_nuts", "eight_schools", "ensemble_walkers",
            "chees_trajectory_adaptation", "bimodal_tempering", "ais_log_z",
            "gp_robust_regression", "streaming_production_run",
            "sgld_minibatch_logreg", "constrained_transforms",
            "bigd_separable_hmc", "poisson_mh", "sharded_chains",
            "sgld_data_parallel")
#: the examples that launch a kernel besides the fused NUTS ones, and
#: their launches: poisson_mh's run(200, 100) in 100-step blocks
KERNEL_EXAMPLES = {"poisson_mh": dict(mh_multistep=3)}
#: the examples that write Parquet, so need pyarrow
PARQUET_EXAMPLES = ("gauss_mh", "streaming_production_run")
#: bigd_separable_hmc's steps a half, run(64, 64): one fused launch each
BIGD_STEPS = 128
BIGD_TOL = 0.02
_BIGD_LINE = re.compile(r"mean ([-+0-9.e]+) .*?var ([-+0-9.e]+)"
                        r"(?: .*?min ([-+0-9.e]+))?")


def nuts_steps(*runs) -> int:
    """Kernel 4's launches in NUTS ``run(n_collect, n_discard)`` calls, a
    launch a step: ``n_collect + n_discard - 1`` steps a run (the first
    draw is the start, ``nuts.py``'s docstring)."""
    return sum(n_collect + n_discard - 1 for n_collect, n_discard in runs)


#: the examples whose NUTS takes Kernel 4 on the card
#: (``mini_mcmc_torch.examples.nuts_tier``) and the exact launches of each
#: example's main: every step a fused launch, of a user library
#: (``nuts_step_user``) where the target has no built-in instance, inside
#: a transform's bijectors (``nuts_step_transformed``) under
#: ``transform=``; every other example but bigd_separable_hmc launches no
#: kernel
FUSED_NUTS_EXAMPLES = {
    "minimal_nuts": dict(nuts_step=nuts_steps((400, 400)),
                         nuts_step_user=nuts_steps((400, 400))),
    "metric_nuts": dict(nuts_step=nuts_steps((100, 200), (500, 100))),
    # two runs of each of the non-centered and the centered forms
    "eight_schools": dict(nuts_step=nuts_steps(*[(1000, 500)] * 4),
                          nuts_step_user=nuts_steps(*[(1000, 500)] * 4)),
    "constrained_transforms": dict(
        nuts_step=nuts_steps((500, 300)),
        nuts_step_user=nuts_steps((500, 300)),
        nuts_step_transformed=nuts_steps((500, 300))),
}


def phase_example_nuts_steps(dev) -> None:
    """``[examples_k4_<example>]``: Kernel 4 against its twin with
    :func:`phase_nuts_step`'s checks (positions, alpha, n_alpha,
    divergences and depths on at least NUTS_SHARE of the chains, the
    launch's leaves, the grid, the same results under other grids) on
    each fused NUTS example's own sampler, built as its ``main`` builds
    it, at its chain count and in the state its first run leaves:
    minimal_nuts' traced 2D Rosenbrock (4 chains), metric_nuts'
    Gaussian2D whitened by its dense metric (256), eight schools'
    traced centered form (16) and constrained_transforms' natural target
    traced inside its bijectors (64). Eight schools' non-centered hand
    source is held at 4,096 chains by phase_user_kernels."""
    from mini_mcmc_torch.examples import constrained_transforms as ct
    from mini_mcmc_torch.examples import eight_schools as es

    kw = dict(device=dev, use_pallas="full")
    s = mt.NUTS(mt.models.rosenbrock2d(a=1.0, b=100.0),
                mt.init(4, 2, device=dev), target_accept_p=0.95,
                **kw).seed(42)
    s.run(400, 400)
    phase_nuts_step(s, dev, "examples_k4_minimal_nuts")
    s = mt.NUTS(mt.models.diffable_gaussian2d(
        [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]), mt.init_det(256, 2,
                                                         device=dev),
        0.8, **kw).seed(0)
    s.run(100, 200)
    phase_nuts_step(s.reconditioned("dense", seed=1), dev,
                    "examples_k4_metric_nuts")
    s = mt.NUTS(es.make_centered_target(), mt.init_with_seed(
        16, 10, seed=5, device=dev), 0.8, **kw).seed(5)
    s.run(1000, 500)
    phase_nuts_step(s, dev, "examples_k4_eight_schools_centered")
    transform = ct.make_transform()
    s = mt.NUTS(ct.make_natural_target(), transform.to_x(mt.init_with_seed(
        64, 2, seed=7, device=dev)), 0.8, transform=transform, **kw).seed(7)
    s.run(500, 300)
    phase_nuts_step(s, dev, "examples_k4_constrained_transforms")


def example_requests(dev) -> list:
    """The user libraries the fused NUTS examples' Kernel 4 runs, as
    ``(source, dim, flags)``, so that phase_build's one nvcc batch builds
    them: minimal_nuts' 2D Rosenbrock and eight schools' centered form,
    traced from their batch forms, and constrained_transforms' natural
    target traced inside its transform's bijectors (eight schools'
    non-centered source is one of ``user_requests``')."""
    from mini_mcmc_torch.examples import constrained_transforms as ct
    from mini_mcmc_torch.examples import eight_schools as es

    return [(t.dc_forms(d, dev).source, d, _build.instance_flags(t))
            for t, d in ((mt.models.rosenbrock2d(1.0, 100.0), 2),
                         (es.make_centered_target(), 10),
                         (ct.make_transform().wrap(
                             ct.make_natural_target()), 2))]


def bigd_moments(text: str) -> list:
    """The (mean, var, min) each half of ``bigd_separable_hmc`` printed
    (``min`` None for the plain half)."""
    out = []
    for line in text.splitlines():
        m = _BIGD_LINE.search(line)
        if m:
            out.append(tuple(None if v is None else float(v)
                             for v in m.groups()))
    check("bigd_separable_hmc printed both halves", len(out) == 2, text)
    return out


def phase_examples(names=EXAMPLES) -> dict:
    """Each example's ``main(device="cuda")`` in turn (phase 40): its wall
    seconds (the device synchronised), its return value, and its launch
    counts, reset just before it and read just after; every example but
    ``bigd_separable_hmc`` and the fused NUTS examples launches no kernel.
    Returns the counts of ``bigd_separable_hmc``'s run by name and the
    Kernel 4 launches of the NUTS examples."""
    have_pyarrow = importlib.util.find_spec("pyarrow") is not None
    out = {"nuts_step": 0}
    for name in names:
        if name in PARQUET_EXAMPLES and not have_pyarrow:
            say("examples", example=name, run="not run",
                why="pyarrow: absent")
            continue
        mod = importlib.import_module(f"mini_mcmc_torch.examples.{name}")
        text, progress = io.StringIO(), io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text), \
                contextlib.redirect_stderr(progress):
            ret = mod.main(device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        more = {}
        if name == "bigd_separable_hmc":
            check("bigd_separable_hmc launches: the fused step 128 a half, "
                  "the transformed instance in the constrained half",
                  counts == counts_with(
                      hmc_separable_step=2 * BIGD_STEPS,
                      hmc_separable_step_transformed=BIGD_STEPS), counts)
            (m0, v0, _), (m1, v1, lo) = bigd_moments(text.getvalue())
            half_mean, half_var = math.sqrt(2 / math.pi), 1 - 2 / math.pi
            for what, got, want in (("mean", m0, 0.0), ("var", v0, 1.0),
                                    ("constrained mean", m1, half_mean),
                                    ("constrained var", v1, half_var)):
                check(f"bigd_separable_hmc {what}",
                      abs(got - want) <= BIGD_TOL, (got, want))
            check("bigd_separable_hmc constrained min > 0", lo > 0.0, lo)
            out["counts"] = counts
            more = dict(launches_fused=counts["hmc_separable_step"],
                        launches_transformed=counts[
                            "hmc_separable_step_transformed"],
                        mean=m0, var=v0, constrained_mean=m1,
                        constrained_var=v1, constrained_min=lo)
        elif name in FUSED_NUTS_EXAMPLES:
            check(f"example {name} launches Kernel 4 a step and nothing "
                  "else", counts == counts_with(**FUSED_NUTS_EXAMPLES[name]),
                  counts)
            more = dict(launches_nuts_step=counts["nuts_step"],
                        launches_user=counts["nuts_step_user"],
                        launches_transformed=counts[
                            "nuts_step_transformed"])
            out["nuts_step"] += counts["nuts_step"]
        elif name in KERNEL_EXAMPLES:
            check(f"example {name} launches", counts == counts_with(
                **KERNEL_EXAMPLES[name]), counts)
            more = {f"launches_{k}": counts[k] for k in KERNEL_EXAMPLES[name]}
            out.update({f"{name}_{k}": counts[k]
                        for k in KERNEL_EXAMPLES[name]})
        else:
            check_no_kernel(f"example {name}")
        if isinstance(ret, torch.Tensor):  # sgld_data_parallel's cube
            ret = f"tensor{tuple(ret.shape)}"
        say("examples", example=name, wall_s=repr(wall),
            returned=repr(ret).replace(" ", ""), **{
                k: repr(v) for k, v in more.items()})
    return out


# ---------------------------------------------------------------------------
# 41. [parallel]: chain and data parallelism through a one-rank mesh
# ---------------------------------------------------------------------------

#: the chain offset of the kernels' checks at chain0 != 0 (a shard's first
#: global chain need not sit at a warp or block boundary)
PAR_CHAIN0 = 1_000_003
#: the one-rank mesh's runs: the flagship's (64 Kernel 2 launches a run),
#: tempering's (32 Kernel 8 launches) and NUTS's on use_pallas=True
PAR_HMC_COLLECT, PAR_PT_COLLECT = 1024, 512
PAR_NUTS_CHAINS, PAR_NUTS_DEPTH, PAR_NUTS_RUN = 4096, 4, (8, 8)
#: data_parallel_grad's problem and the keys of its scale check
PAR_DPG_ROWS, PAR_DPG_DIM, PAR_DPG_CHAINS, PAR_DPG_BATCH = 65536, 8, 1024, 4096
PAR_DPG_KEYS = 256


def parallel_pair(label: str, make, run_args, mesh, time_major=False,
                  scalar_only=False) -> dict:
    """One sampler from one seed, unsharded and through
    ``shard_sampler_state(mesh, ...)``, each by :func:`timed_run` (a
    warm-up, then the timed run): the timed cubes equal bit for bit, the
    same kernel launches and twin calls, no collective in the sharded runs
    (with ``scalar_only``: one-element all-reduces only), the split R-hat
    and ESS of the sharded cube the unsharded one's. Returns the seconds
    and the counts."""
    from mini_mcmc_torch.parallel import collectives, shard_sampler_state

    a = make()
    reset_counts()
    want, wall_a = timed_run(a, *run_args, time_major=time_major)
    counts_a = read_counts()
    b = make()
    b.state = shard_sampler_state(mesh, b.state)
    reset_counts()
    collectives.reset_counts()
    got, wall_b = timed_run(b, *run_args, time_major=time_major)
    counts_b, coll = read_counts(), collectives.counts()
    local = got.to_local()
    equal = bool(torch.equal(want, local))
    ra, ea = mt.split_rhat_mean_ess(want, time_major=time_major)
    rb, eb = mt.split_rhat_mean_ess(got, time_major=time_major)
    diag = bool(torch.equal(ra, rb) and torch.equal(ea, eb))
    launched = {k: v for k, v in counts_b.items() if v}
    say("parallel", path=label, chains=b.n_chains,
        cube=tuple(got.shape), placement=str(got.placements[0]),
        cube_equal=equal, diagnostics_equal=diag,
        launches=repr(launched).replace(" ", ""),
        launches_equal=counts_a == counts_b,
        collectives=repr(coll).replace(" ", ""),
        unsharded_s=repr(wall_a), sharded_s=repr(wall_b),
        overhead=repr(wall_b / wall_a - 1.0))
    check(f"parallel {label} cube equal", equal, label)
    check(f"parallel {label} launches equal", counts_a == counts_b,
          (counts_a, counts_b))
    check(f"parallel {label} diagnostics equal", diag,
          (ra, rb, ea, eb))
    if scalar_only:
        check(f"parallel {label} scalar reductions only",
              coll["all_reduce"] == coll["all_reduce_scalar"]
              and not coll["all_gather"] and not coll["broadcast"], coll)
    else:
        check(f"parallel {label} no collective", not any(coll.values()),
              coll)
    return {"unsharded_s": wall_a, "sharded_s": wall_b, "counts": counts_b,
            "collectives": coll}


def split_cases(dev) -> dict:
    """Kernels 2-8 at their main paths' shapes, from states drawn from
    their targets: name -> (C, launch(lo, hi, chain0) -> [(output, its
    chain axis)]), the launch running chains ``[lo, hi)`` as global
    chains ``chain0 ...``."""
    gen = torch.Generator(device=dev).manual_seed(4141)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    cases = {}
    # Kernel 2: the flagship block, K = 16, L = 192, jittered steps
    rosen = mt.rosenbrock_nd()
    x2 = randn(N_CHAINS, DIM) * 0.3 + 0.9
    lp2, g2 = rosen.batch_logp_and_grad(x2)
    eps2 = STEP_SIZE * (1.0 + JITTER * (2.0 * torch.rand(
        (STEPS_PER_CALL,), generator=gen, device=dev) - 1.0))

    def k2(lo, hi, c0):
        h = torch.empty((STEPS_PER_CALL, hi - lo, DIM), device=dev)
        o = hmc_multistep(rosen, x2[lo:hi], lp2[lo:hi], g2[lo:hi], eps2,
                          N_LEAPFROG, 0x5EED_2222, 11, h, chain0=c0)
        return [(o[0], 0), (o[1], 0), (o[2], 0), (h, 1)]

    cases["hmc_multistep"] = (N_CHAINS, k2)
    # Kernels 3 and 4: the NUTS stage's Gaussian at 131,072 chains
    gauss = mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV)
    x3 = randn(NUTS_CHAINS, 2) * 1.5 + torch.tensor(NUTS_MEAN, device=dev)
    m3 = randn(NUTS_CHAINS, 2)
    lp3, g3 = gauss.batch_logp_and_grad(x3)
    joint0 = lp3 - 0.5 * (m3 * m3).sum(dim=1)
    logu = joint0 - torch.empty_like(joint0).exponential_(generator=gen)
    u = torch.rand((3, NUTS_CHAINS), generator=gen, device=dev)
    v = torch.where(u[0] < 0.5, -1, 1).to(torch.int32)
    active = u[1] < 0.9
    eps3 = 0.3 + 0.9 * u[2]

    def k3(lo, hi, c0):
        r = subtree(gauss, x3[lo:hi], m3[lo:hi], g3[lo:hi], logu[lo:hi],
                    v[lo:hi], 4, eps3[lo:hi], joint0[lo:hi],
                    active[lo:hi], (0x1234567, -0x7654321), NUTS_MAX_DEPTH,
                    chain0=c0)
        return [(t, 0) for t in r]

    def k4(lo, hi, c0):
        return [(t, 0) for t in nuts_step(
            gauss, x3[lo:hi], eps3[lo:hi], NUTS_MAX_DEPTH,
            0x5EED_0123_4567_89AB, 9, NUTS_MAX_DEPTH, c0)]

    cases["nuts_subtree"] = (NUTS_CHAINS, k3)
    cases["nuts_step"] = (NUTS_CHAINS, k4)
    # Kernel 5: the MH stage's Gaussian2D, K = 16
    g2d = mt.gaussian2d([0.0, 0.0], [[1.0, 0.0], [0.0, 1.0]])
    walk = mt.isotropic_gaussian_proposal(1.0)
    x5 = randn(MH_CHAINS, 2)
    lp5 = g2d.batch_logp(x5)

    def k5(lo, hi, c0):
        h = torch.empty((MH_K, hi - lo, 2), device=dev)
        o = mh_multistep(g2d, walk, x5[lo:hi], lp5[lo:hi], 0x5EED_0808, 3,
                         MH_K, h, chain0=c0)
        return [(o[0], 0), (o[1], 0), (h, 1)]

    cases["mh_multistep"] = (MH_CHAINS, k5)
    # Kernel 6: the mixture's Gibbs sweeps, K = 32
    cond = mt.gaussian_mixture_conditional(*MIX)
    z = (torch.rand(MH_CHAINS, generator=gen, device=dev) >= MIX[4]).float()
    n = randn(MH_CHAINS)
    x6 = torch.stack([torch.where(z > 0, MIX[2] + MIX[3] * n,
                                  MIX[0] + MIX[1] * n), z], dim=1)

    def k6(lo, hi, c0):
        h = torch.empty((GIBBS_K, hi - lo, 2), device=dev)
        o = gibbs_multistep(cond, x6[lo:hi], 0x5EED_3232, 5, GIBBS_K, h,
                            chain0=c0)
        return [(o, 0), (h, 1)]

    cases["gibbs_multistep"] = (MH_CHAINS, k6)
    # Kernel 7: the separable stage's fused step, 1,024 x 10,000, L = 10
    sn = mt.standard_normal()
    x7 = randn(SEP_CHAINS, SEP_DIM)
    lp7 = sn.batch_logp(x7)
    eps7 = torch.tensor([SEP_EPS], device=dev)
    tables = x7.new_empty((0, SEP_DIM))

    def k7(lo, hi, c0):
        return [(t, 0) for t in hmc_separable_step(
            sn, x7[lo:hi], lp7[lo:hi], eps7, SEP_L, 0x5EED_7777, 6, tables,
            chain0=c0)]

    cases["hmc_separable_step"] = (SEP_CHAINS, k7)
    # Kernel 8: the tempering stage's mixture, 8,192 chains x 8 rungs
    mix = pt_mixture()
    side = torch.where(torch.rand((PT_TEMPS, 1, PT_CHAINS), generator=gen,
                                  device=dev) < PT_W_PLUS, 8.0, -8.0)
    x8 = side + 0.5 * randn(PT_TEMPS, 1, PT_CHAINS)
    lp8 = mix.batch_logp(x8.permute(0, 2, 1).reshape(-1, 1)).reshape(
        PT_TEMPS, PT_CHAINS)
    sa8 = torch.zeros((PT_TEMPS - 1, PT_CHAINS), device=dev)
    lad = make_ladder(mt.geometric_betas(PT_TEMPS, 0.01), 1.0, 1, dev)

    def k8(lo, hi, c0):
        h = torch.empty((PT_K, hi - lo, 1), device=dev)
        o = pt_multistep(mix, x8[..., lo:hi].contiguous(),
                         lp8[:, lo:hi].contiguous(),
                         sa8[:, lo:hi].contiguous(), 1, lad, 0x5EED_8888, 7,
                         PT_K, 1, h, chain0=c0)
        return [(o[0], 2), (o[1], 1), (o[2], 1), (h, 1)]

    cases["pt_multistep"] = (PT_CHAINS, k8)
    return cases


def phase_parallel_split(dev) -> dict:
    """``[parallel_split]``: each of Kernels 2-8 launched on chains ``[0,
    s)`` at chain0 = 0 and on ``[s, C)`` at chain0 = s, for s = C / 2 and
    an odd s (C / 3 made odd: no warp, block or cluster boundary of the
    one launch), against one launch over ``[0, C)``: every output bit for
    bit. Returns, by kernel, whether both splits matched."""
    out = {}
    for name, (c, launch) in split_cases(dev).items():
        full = launch(0, c, 0)
        ok = {}
        for s in (c // 2, (c // 3) | 1):
            lo, hi = launch(0, s, 0), launch(s, c, s)
            ok[s] = all(bool(torch.equal(torch.cat([a, b], dim=ax), f))
                        for (f, ax), (a, _), (b, _) in zip(full, lo, hi))
        torch.cuda.synchronize()
        say("parallel_split", kernel=name, chains=c,
            **{f"split_{s}_equal": v for s, v in ok.items()})
        check(f"parallel split {name}", all(ok.values()), ok)
        out[name] = all(ok.values())
    return out


def phase_parallel_dpg(dev) -> dict:
    """``[parallel_dpg]``: ``data_parallel_grad`` on a one-rank data mesh
    over a linear regression's rows (N = 65,536, D = 8), 1,024 chains, B
    = 4,096: one all-reduce a call, finite, the mean over 256 keys at the
    full-data gradient's scale (ratio within 10%: a doubled reduction
    gives 2), the ms a call (CUDA events) and the all-reduce's alone on
    the ``[C, D]`` partial."""
    import torch.distributed as dist

    from mini_mcmc_torch.parallel import collectives, data_mesh

    mesh = data_mesh()
    gen = torch.Generator(device=dev).manual_seed(77)
    x = torch.randn((PAR_DPG_ROWS, PAR_DPG_DIM), generator=gen, device=dev)
    w = torch.linspace(-1.0, 1.0, PAR_DPG_DIM, device=dev)
    y = x @ w + 0.5 * torch.randn(PAR_DPG_ROWS, generator=gen, device=dev)

    def log_prior(b):
        return -0.5 * torch.sum(b * b)

    def log_like(b, batch):
        r = batch[1] - batch[0] @ b
        return -2.0 * torch.sum(r * r)

    gf = mt.data_parallel_grad(log_prior, log_like, (x, y), PAR_DPG_BATCH,
                               mesh)
    pos = 0.1 * torch.randn((PAR_DPG_CHAINS, PAR_DPG_DIM), generator=gen,
                            device=dev)
    key = torch.Generator(device=dev).manual_seed(3)
    collectives.reset_counts()
    g = gf(pos, key)
    one = collectives.counts()
    check("parallel dpg one all-reduce a call", one["all_reduce"] == 1
          and sum(one.values()) - one["all_reduce_scalar"] == 1, one)
    check("parallel dpg finite", bool(torch.isfinite(g).all()), "nan")
    avg = torch.zeros_like(g, dtype=torch.float64)
    for _ in range(PAR_DPG_KEYS):
        avg += gf(pos, key).double()
    avg /= PAR_DPG_KEYS
    b = pos.detach().requires_grad_(True)
    full = torch.autograd.grad(
        (torch.func.vmap(log_prior)(b)
         + torch.func.vmap(log_like, in_dims=(0, None))(b, (x, y))).sum(),
        b)[0].double()
    ratio = float((avg * full).sum() / (full * full).sum())
    part = torch.zeros_like(g)
    group = mesh.get_group(0)
    t = {"ms": cuda_ms(lambda: gf(pos, key), 50),
         "all_reduce_ms": cuda_ms(lambda: dist.all_reduce(part,
                                                          group=group), 200)}
    say("parallel_dpg", rows=PAR_DPG_ROWS, dim=PAR_DPG_DIM,
        chains=PAR_DPG_CHAINS, batch=PAR_DPG_BATCH, keys=PAR_DPG_KEYS,
        collectives_per_call=repr(one).replace(" ", ""),
        scale_ratio=repr(ratio), **{k: repr(v) for k, v in t.items()})
    check("parallel dpg at the full gradient's scale",
          abs(ratio - 1.0) <= 0.1, ratio)
    return t


def phase_parallel_draws(dev) -> dict:
    """``[parallel_draws]``: what drawing the global shape costs a shard of
    the lockstep tiers (``collectives.chain_draw``): one lockstep HMC
    step's draws, a ``[C, D]`` normal and a ``[C]`` uniform from the
    step's generator, at the flagship's 65,536 x 3 (what every shard
    draws) and at its share on 2 and 4 ranks (what it keeps), CUDA events
    over 200 draws. A one-rank mesh draws its own shape."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def step_draws(c):
        torch.randn((c, DIM), generator=gen, device=dev)
        torch.rand((c,), generator=gen, device=dev)

    out = {f"draws_ms_{N_CHAINS // r}": cuda_ms(
        lambda r=r: step_draws(N_CHAINS // r), 200) for r in (1, 2, 4)}
    say("parallel_draws", dim=DIM, **{k: repr(v) for k, v in out.items()})
    return out


def phase_parallel(dev) -> dict:
    """``[parallel]`` (41): the one-rank NCCL chain mesh's runs of the
    flagship (Kernel 2), tempering (Kernel 8) and NUTS on
    ``use_pallas=True`` (Kernel 3), the split launches of Kernels 2-8 and
    ``data_parallel_grad``. Returns the runs' launches and seconds."""
    import torch.distributed as dist

    from mini_mcmc_torch.parallel import chain_mesh

    t0 = time.perf_counter()
    mesh = chain_mesh()
    say("parallel_mesh", ranks=mesh.size(), backend=dist.get_backend(),
        device_type=mesh.device_type)
    check("parallel one-rank NCCL mesh", mesh.size() == 1
          and dist.get_backend() == "nccl", mesh)
    out = {"hmc": parallel_pair(
        "hmc_full", lambda: flagship(dev, seed=42), (PAR_HMC_COLLECT, 0),
        mesh, time_major=True)}
    check("parallel hmc_full Kernel 2 launches",
          out["hmc"]["counts"]["hmc_multistep"]
          == 2 * PAR_HMC_COLLECT // STEPS_PER_CALL, out["hmc"]["counts"])
    out["pt"] = parallel_pair(
        "pt_full", lambda: mt.ParallelTempering(
            pt_mixture(), torch.full((PT_CHAINS, 1), -8.0, device=dev),
            betas=mt.geometric_betas(PT_TEMPS, 0.01), proposal_std=1.0,
            steps_per_call=PT_K, use_pallas="full").seed(5),
        (PAR_PT_COLLECT, 0), mesh, time_major=True)
    check("parallel pt_full Kernel 8 launches",
          out["pt"]["counts"]["pt_multistep"] == 2 * PAR_PT_COLLECT // PT_K,
          out["pt"]["counts"])
    init = mt.init_with_seed(PAR_NUTS_CHAINS, 2, seed=3, device=dev)
    out["nuts"] = parallel_pair(
        "nuts_true", lambda: mt.NUTS(
            mt.diffable_gaussian2d(NUTS_MEAN, NUTS_COV), init, 0.8,
            max_depth=PAR_NUTS_DEPTH, use_pallas=True).seed(9),
        PAR_NUTS_RUN, mesh, scalar_only=True)
    check("parallel nuts_true Kernel 3 launched",
          out["nuts"]["counts"]["nuts_subtree"] > 0, out["nuts"]["counts"])
    out["split"] = phase_parallel_split(dev)
    out["dpg"] = phase_parallel_dpg(dev)
    out["draws"] = phase_parallel_draws(dev)
    out["seconds"] = time.perf_counter() - t0
    say("parallel_times", seconds=repr(out["seconds"]),
        **{f"{k}_unsharded_s": repr(out[k]["unsharded_s"])
           for k in ("hmc", "pt", "nuts")},
        **{f"{k}_sharded_s": repr(out[k]["sharded_s"])
           for k in ("hmc", "pt", "nuts")})
    return out


# ---------------------------------------------------------------------------
# 42. [state_mesh]: the state dimension over a "state" axis, one rank
# ---------------------------------------------------------------------------

#: the D-slices of the split check, and the runs on the 1 x 1 mesh
STATE_SPLITS = (2, 4)
STATE_SEP_RUN, STATE_LOCKSTEP_RUN = (16, 16), (4, 4)
#: the phase's limit in seconds
STATE_MESH_S = 30.0


def state_split_check(name: str, target, x, eps) -> dict:
    """Kernel 7's trajectory form on ``x`` whole and in 2 and 4 D-slices
    (``d0`` the slice's first coordinate): positions bit for bit, summed
    energies within ``SEP_SUM_RTOL``, each slice against its float64 twin
    at its ``d0`` (positions per chain on >= 99.9% of chains, the three
    sums within ``SEP_SUM_RTOL``). Returns the results by split."""
    c, d = x.shape
    tables = sep_tables(target, x)
    seed, step = 0x5EED_2323_0707, 9
    whole = hmc_separable(target, x, eps, SEP_L, seed, step, tables)
    out = {}
    for n in STATE_SPLITS:
        w = d // n
        slices = []
        for d0 in range(0, d, w):
            xs = x[:, d0:d0 + w].contiguous()
            ts = tables[:, d0:d0 + w].contiguous()
            got = hmc_separable(target, xs, eps, SEP_L, seed, step, ts,
                                d0=d0, n_dim=d)
            ref = hmc_separable_plain(target, xs.double(), eps.double(),
                                      SEP_L, seed, step, ts.double(), d0=d0)
            agree = float(chain_agree(got[0], ref[0].float()).float().mean())
            sums = max(float(((g.double() - r).abs() / r.abs().clamp_min(
                1e-30)).max()) for g, r in zip(got[1:4], ref[1:4]))
            slices.append((d0, got, agree, sums))
        torch.cuda.synchronize()
        pos_equal = bool(torch.equal(
            torch.cat([g[0] for _, g, _, _ in slices], dim=1), whole[0]))
        sum_err = max(float(((sum(g[i] for _, g, _, _ in slices).double()
                              - whole[i].double()).abs()
                             / whole[i].double().abs()).max())
                      for i in (1, 2, 3))
        twin = min(a for _, _, a, _ in slices)
        twin_sums = max(e for _, _, _, e in slices)
        say("state_mesh_split", target=name, chains=c, D=d, slices=n,
            d0=",".join(str(d0) for d0, _, _, _ in slices),
            positions_equal=pos_equal, sums_rel_err=repr(sum_err),
            twin_positions_share=repr(twin), twin_sums_rel_err=repr(
                twin_sums))
        check(f"state split {name} {n} slices positions equal one launch",
              pos_equal, n)
        check(f"state split {name} {n} slices sums",
              sum_err <= SEP_SUM_RTOL, sum_err)
        check(f"state split {name} {n} slices against the twin at d0",
              twin >= 0.999 and twin_sums <= SEP_SUM_RTOL,
              (twin, twin_sums))
        out[n] = pos_equal and sum_err <= SEP_SUM_RTOL
    return out


#: the samplers this slice splits, their runs at the separable stage's
#: 1,024 x 10,000: MH's isotropic walk (2.4 / sqrt(D), the random walk's
#: optimal scale), SGLD on a standard normal's gradient, lockstep NUTS
STATE_MH_RUN, STATE_SGLD_RUN, STATE_NUTS_RUN = (16, 0), (16, 0), (4, 4)
STATE_MH_STD, STATE_SGLD_EPS = 0.024, 0.05
#: NUTS's tree-depth cap on these paths: the lockstep loop runs the
#: deepest of 1,024 trees, at the default 10 up to 1,023 leaves a step
#: (5,410 leaves in 7 steps, 8.7 s on an H100 at 700 W; PERF.md)
STATE_NUTS_DEPTH = 6


def state_sampler_makes(dev, chains: int, dim: int,
                        dtype=torch.float32) -> tuple:
    """``(label, make, run_args)`` of lockstep MH, SGLD and NUTS at
    ``chains x dim`` from seed 12 on ``dev``."""
    from mini_mcmc_torch.models import isotropic_gaussian_proposal

    def init():
        return mt.init_with_seed(chains, dim, seed=12,
                                 device=dev).to(dtype)

    return (
        ("mh", lambda: mt.MetropolisHastings(
            mt.standard_normal(), isotropic_gaussian_proposal(STATE_MH_STD),
            init(), device=dev).seed(12), STATE_MH_RUN),
        ("sgld", lambda: mt.SGLD(mt.target_grad(mt.standard_normal()),
                                 init(), STATE_SGLD_EPS,
                                 device=dev).seed(12), STATE_SGLD_RUN),
        ("nuts", lambda: mt.NUTS(counted_normal(), init(),
                                 max_depth=STATE_NUTS_DEPTH,
                                 device=dev).seed(12), STATE_NUTS_RUN),
    )


#: the gradient calls of :func:`counted_normal` targets: one a target
#: evaluation (a step's start, a leaf, a step-size trial)
NORMAL_CALLS = [0]


def counted_normal():
    """A standard normal whose gradient counts its calls in
    ``NORMAL_CALLS``: the lockstep NUTS paths' target evaluations."""
    from mini_mcmc_torch.models.base import Target

    def grad(x):
        NORMAL_CALLS[0] += 1
        return -x

    return Target(logp=lambda x: -0.5 * torch.sum(x * x, dim=-1),
                  grad=grad)


#: the lockstep samplers' legs, each (label, chains, dim, run):
#: ChEES-HMC, elliptical slice (a scalar prior) and plain tempering (4
#: rungs) at the separable stage's 1,024 x 10,000, the ensemble at D = 512
#: (one ensemble of all 1,024 walkers, >= D + 2), the slice sweep at 256 x
#: 64 (a sweep is D coordinate updates of a few evaluations each, every
#: one a host test and, split, an all-reduce)
STATE_LOCKSTEP_LEGS = (
    ("chees", SEP_CHAINS, SEP_DIM, (16, 0)),
    ("elliptical", SEP_CHAINS, SEP_DIM, (16, 0)),
    ("tempering", SEP_CHAINS, SEP_DIM, (16, 0)),
    ("ensemble", 1024, 512, (16, 0)),
    ("slice", 256, 64, (2, 0)),
)
#: the legs whose runs move every chain at every step, so that a chain
#: whose decision flipped shows no step where one run stayed: on float64
#: states in ``[state_mesh_ranks]``, where a reordered sum over D flips no
#: decision, every chain must equal unsharded bit for bit
STATE_EXACT_LEGS = ("slice", "elliptical")
#: ChEES-HMC's step size and trajectory length on these legs (at most 5
#: leapfrogs a step), tempering's cold walk (2.4 / sqrt(D)) and ladder
STATE_CHEES_EPS, STATE_CHEES_T = 0.2, 1.0
STATE_PT_STD, STATE_PT_TEMPS = 0.024, 4
#: the float64 ChEES warm-up of [state_mesh_ranks]
STATE_CHEES_WARMUP = 16
#: the logp calls of :func:`logp_counted_normal` targets: one a density
#: evaluation, and so one all-reduce a call on a split
LOGP_CALLS = [0]


def logp_counted_normal():
    """A standard normal whose logp counts its calls in ``LOGP_CALLS``,
    its gradient elementwise."""
    from mini_mcmc_torch.models.base import Target

    def logp(x):
        LOGP_CALLS[0] += 1
        return -0.5 * torch.sum(x * x, dim=-1)

    return Target(logp=logp, grad=lambda x: -x)


def state_lockstep_makes(dev, dtype=torch.float32) -> tuple:
    """``(label, make, run_args)`` of :data:`STATE_LOCKSTEP_LEGS` from
    seed 12 on ``dev``."""
    def init(c, d):
        return mt.init_with_seed(c, d, seed=12, device=dev).to(dtype)

    builders = {
        "chees": lambda c, d: mt.ChEESHMC(
            logp_counted_normal(), init(c, d), STATE_CHEES_EPS,
            traj_len=STATE_CHEES_T, device=dev),
        "elliptical": lambda c, d: mt.EllipticalSliceSampler(
            logp_counted_normal(), init(c, d), device=dev),
        "tempering": lambda c, d: mt.ParallelTempering(
            logp_counted_normal(), init(c, d),
            betas=mt.geometric_betas(STATE_PT_TEMPS, 0.1),
            proposal_std=STATE_PT_STD, device=dev),
        "ensemble": lambda c, d: mt.EnsembleSampler(
            logp_counted_normal(), init(c, d), walkers_per_ensemble=c,
            device=dev),
        "slice": lambda c, d: mt.SliceSampler(logp_counted_normal(),
                                              init(c, d), device=dev),
    }
    return tuple(
        (label, lambda b=builders[label], c=c, d=d: b(c, d).seed(12), run)
        for label, c, d, run in STATE_LOCKSTEP_LEGS)


def state_mesh_pair(label: str, make, run_args, mesh,
                    scalar_only: bool = False) -> dict:
    """One sampler from one seed, unsharded and through
    ``shard_sampler_state(mesh, ..., shard_state_dim=True)``: cubes equal
    bit for bit, the same kernel launches and twin calls, no collective
    in the split run (``scalar_only``: none but the chain axis's scalar
    loop exits, NUTS's). Returns the split run's counts."""
    from mini_mcmc_torch.parallel import collectives, shard_sampler_state

    a = make()
    reset_counts()
    want = a.run(*run_args, time_major=True)
    counts_a = read_counts()
    b = make()
    b.state = shard_sampler_state(mesh, b.state, shard_state_dim=True)
    reset_counts()
    collectives.reset_counts()
    t0 = time.perf_counter()
    got = b.run(*run_args, time_major=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts_b, coll = read_counts(), collectives.counts()
    equal = bool(torch.equal(want, got.to_local()))
    launched = {k: v for k, v in counts_b.items() if v}
    say("state_mesh", path=label, chains=b.n_chains, dim=b.dim,
        run=",".join(map(str, run_args)), cube=tuple(got.shape),
        placements=",".join(str(p) for p in got.placements),
        cube_equal=equal, launches=repr(launched).replace(" ", ""),
        launches_equal=counts_a == counts_b,
        collectives=repr(coll).replace(" ", ""), seconds=repr(seconds))
    check(f"state mesh {label} cube equal", equal, label)
    check(f"state mesh {label} launches equal", counts_a == counts_b,
          (counts_a, counts_b))
    if scalar_only:
        check(f"state mesh {label} chain-axis scalars only",
              coll["all_reduce"] == coll["all_reduce_scalar"]
              and not coll["all_gather"] and not coll["broadcast"], coll)
    else:
        check(f"state mesh {label} no collective", not any(coll.values()),
              coll)
    check(f"state mesh {label} D on the state axis",
          str(got.placements[1]) == "S(2)", got.placements)
    return counts_b


def phase_state_mesh(dev) -> dict:
    """``[state_mesh]`` (42): the one-rank ``chain_state_mesh(1, 1)``'s
    separable and lockstep runs against unsharded, and Kernel 7 at
    D-slices (:func:`state_split_check`). Returns Kernel 7's launches on
    the mesh, the split results and the seconds."""
    import torch.distributed as dist

    from mini_mcmc_torch.parallel import chain_state_mesh

    t0 = time.perf_counter()
    mesh = chain_state_mesh(1, 1)
    say("state_mesh_mesh", shape=tuple(mesh.shape),
        dims=",".join(mesh.mesh_dim_names), backend=dist.get_backend())

    def make(tier):
        return lambda: mt.HMC(
            mt.standard_normal(),
            mt.init_with_seed(SEP_CHAINS, SEP_DIM, seed=12, device=dev),
            SEP_EPS, SEP_L, use_pallas=tier).seed(12)

    counts = state_mesh_pair("separable", make("separable"), STATE_SEP_RUN,
                             mesh)
    steps = sum(STATE_SEP_RUN)
    check("state mesh separable: the fused Kernel 7 each step",
          counts == counts_with(hmc_separable_step=steps), counts)
    lock = state_mesh_pair("lockstep", make(False), STATE_LOCKSTEP_RUN, mesh)
    check("state mesh lockstep launches no kernel",
          not any(lock[k] for k in KERNELS), lock)
    for label, sampler, run_args in state_sampler_makes(dev, SEP_CHAINS,
                                                        SEP_DIM):
        got = state_mesh_pair(label, sampler, run_args, mesh,
                              scalar_only=label.startswith("nuts"))
        check(f"state mesh {label} launches no kernel",
              not any(got[k] for k in KERNELS), got)
    # the masked loops of the slice and elliptical samplers exit on the
    # chain axis's scalars
    for label, sampler, run_args in state_lockstep_makes(dev):
        got = state_mesh_pair(label, sampler, run_args, mesh,
                              scalar_only=label in ("slice", "elliptical"))
        check(f"state mesh {label} launches no kernel",
              not any(got[k] for k in KERNELS), got)
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(23)
    z = torch.randn((SEP_CHAINS, SEP_DIM), generator=gen, device=dev)
    sigma = torch.logspace(-1, 1, SEP_DIM, device=dev)
    split = {
        "standard_normal": state_split_check(
            "standard_normal", mt.standard_normal(), z,
            torch.tensor([SEP_EPS], device=dev)),
        "sigma_table": state_split_check(
            "sigma_table", sigma_table_normal(sigma), z * sigma,
            torch.tensor([0.01], device=dev)),
    }
    seconds = time.perf_counter() - t0
    say("state_mesh_times", seconds=repr(seconds), limit_s=STATE_MESH_S)
    check(f"state mesh phase within {STATE_MESH_S} s",
          seconds <= STATE_MESH_S, seconds)
    return {"launches": counts["hmc_separable_step"], "split": split,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# 42b. [state_mesh_ranks]: a two-rank state split on the one card
# ---------------------------------------------------------------------------

#: the ranks of the split, their runs, their limit in seconds
STATE_RANKS = 2
STATE_RANK_SEP_RUN, STATE_RANK_LOCKSTEP_RUN = (16, 0), (4, 0)
STATE_RANKS_S = 240.0
#: the share of chains whose split cube must equal the unsharded cube bit
#: for bit: the energies are summed in another order, so a chain whose
#: accept test lies within float32 rounding of its uniform may decide the
#: other way (and then differ from that step on)
STATE_RANK_SHARE = 0.99
#: NUTS without adaptation in the ranks' phase (its step-size search, then
#: the steps at the found size), and the float64 adaptation run's bound on
#: each chain's distance from unsharded
STATE_RANK_NUTS_RUN = (4, 0)
STATE_ADAPT_ATOL = 1e-6


def state_rank_runs(rank: int, world: int, init_method: str, device: str,
                    chains: int, dim: int) -> dict:
    """On rank ``rank`` of a ``world``-rank gloo group on ``device``
    (every rank on the one card): the separable tier (two-pass Kernel 7 at
    the rank's D-slice, one all-reduce a step) and lockstep HMC at
    ``chains x dim`` on ``chain_state_mesh(1, world)``, each from one
    seed unsharded and split. Returns, per path, the share of chains
    whose block equals the unsharded cube's bit for bit, the largest
    difference, each step's per-chain moves (one decision per chain on
    every shard), the kernel launches and the port's collectives."""
    import torch.distributed as dist

    from mini_mcmc_torch.parallel import (chain_state_mesh, collectives,
                                          shard_sampler_state)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        dev = torch.device(device)
        mesh = chain_state_mesh(1, world, device=device)
        out = {}
        for label, tier, run_args in (
                ("separable", "separable", STATE_RANK_SEP_RUN),
                ("lockstep", False, STATE_RANK_LOCKSTEP_RUN)):
            def make():
                return mt.HMC(mt.standard_normal(),
                              mt.init_with_seed(chains, dim, seed=12,
                                                device=dev),
                              SEP_EPS, SEP_L, use_pallas=tier,
                              device=dev).seed(12)

            a = make()
            x0 = a.state.positions.clone()
            want = a.run(*run_args, time_major=True)
            b = make()
            b.state = shard_sampler_state(mesh, b.state,
                                          shard_state_dim=True)
            reset_counts()
            collectives.reset_counts()
            t0 = time.perf_counter()
            got = b.run(*run_args, time_major=True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts, coll = read_counts(), collectives.counts()
            local = got.to_local()
            w = local.shape[2]
            block = want[:, :, rank * w:(rank + 1) * w]
            start = x0[None, :, rank * w:(rank + 1) * w]
            same = (local == block).all(dim=2).all(dim=0)
            # a chain that differs first differs at an accept decision
            # that went the other way: one run moved and the other stayed
            moved_a, moved_b = ((torch.cat([start, c])[1:]
                                 != torch.cat([start, c])[:-1]).any(dim=2)
                                for c in (block, local))
            differ = (local != block).any(dim=2)
            first = differ.float().argmax(dim=0)[~same]
            cols = (~same).nonzero().flatten()
            out[label] = dict(
                share=float(same.float().mean()),
                flips_only=bool((moved_a[first, cols]
                                 != moved_b[first, cols]).all()),
                max_err=float((local - block).abs().max()),
                # a list: a tensor would cross the queue as a shared
                # file, gone when this process exits
                moved=(local[1:] != local[:-1]).any(dim=2).tolist(),
                local=tuple(local.shape), d0=rank * w,
                placements=",".join(str(p) for p in got.placements),
                launches={k: v for k, v in counts.items() if v},
                collectives={k: v for k, v in coll.items() if v},
                seconds=seconds)
        out.update(state_rank_sampler_runs(rank, dev, mesh, chains, dim))
        out.update(state_rank_lockstep_runs(rank, dev, mesh))
        return out
    finally:
        dist.destroy_process_group()


def _rank_block(full: torch.Tensor, local: torch.Tensor, rank: int):
    """The rank's D-slice of an unsharded ``[N, C, D]`` cube."""
    w = local.shape[2]
    return full[:, :, rank * w:(rank + 1) * w]


def _chains_decided(block, local, start, merges: bool = False) -> tuple:
    """``(share of chains equal bit for bit, whether each differing chain
    first differs where one run moved and the other stayed, or, with
    ``merges`` (NUTS), jumped more than rounding, a flipped merge)`` for a
    rank's ``[N, C, w]`` cube against the unsharded block, ``start`` the
    ``[1, C, w]`` positions before it."""
    same = (local == block).all(dim=2).all(dim=0)
    moved_a, moved_b = ((torch.cat([start, c])[1:]
                         != torch.cat([start, c])[:-1]).any(dim=2)
                        for c in (block, local))
    differ = (local != block).any(dim=2)
    first = differ.float().argmax(dim=0)[~same]
    cols = (~same).nonzero().flatten()
    jump = (local[first, cols] - block[first, cols]).abs().amax(dim=1)
    flipped = moved_a[first, cols] != moved_b[first, cols]
    return (float(same.float().mean()),
            bool((flipped | (merges & (jump > 1e-3))).all()))


def state_rank_sampler_runs(rank: int, dev, mesh, chains: int,
                            dim: int) -> dict:
    """This slice's split samplers on one rank of ``[state_mesh_ranks]``:
    MH run(16, 0), SGLD run(16, 0) and NUTS run(4, 0) in float32 against
    unsharded chain by chain, and NUTS run(4, 4) on float64 states within
    ``STATE_ADAPT_ATOL`` (its dual averaging amplifies the reordered sums'
    rounding, so no float32 chain stays bit for bit under adaptation).
    Each path's kernel launches, the port's collectives and DTensor's
    (``CommDebugMode``), the executed leapfrogs and its seconds."""
    from torch.distributed.tensor.debug import CommDebugMode

    from mini_mcmc_torch.parallel import collectives, shard_sampler_state

    paths = list(state_sampler_makes(dev, chains, dim))
    paths[2] = ("nuts", paths[2][1], STATE_RANK_NUTS_RUN)
    paths.append(("nuts_adapt", state_sampler_makes(
        dev, chains, dim, torch.float64)[2][1], STATE_NUTS_RUN))
    out = {}
    for label, make, run_args in paths:
        a = make()
        x0 = a.positions.clone()
        want = a.run(*run_args, time_major=True)
        b = make()
        b.state = shard_sampler_state(mesh, b.state, shard_state_dim=True)
        reset_counts()
        collectives.reset_counts()
        NORMAL_CALLS[0] = 0
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            got = b.run(*run_args, time_major=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, coll = read_counts(), collectives.counts()
        local = got.to_local()
        block = _rank_block(want, local, rank)
        start = x0[None, :, rank * local.shape[2]:
                   (rank + 1) * local.shape[2]]
        share, decided = _chains_decided(block, local, start,
                                         merges=label.startswith("nuts"))
        err = (local - block).abs().amax(dim=(0, 2))
        res = dict(
            share=share, decided=decided, max_err=float(err.max()),
            close_share=float((err <= STATE_ADAPT_ATOL).float().mean()),
            moved=(local[1:] != local[:-1]).any(dim=2).tolist(),
            local=tuple(local.shape), d0=rank * local.shape[2],
            launches={k: v for k, v in counts.items() if v},
            collectives={k: v for k, v in coll.items() if v},
            dtensor_all_reduces=sum(
                n for op, n in comm.get_comm_counts().items()
                if "all_reduce" in str(op)),
            steps=sum(run_args), seconds=seconds)
        if label.startswith("nuts"):
            res["evaluations"] = NORMAL_CALLS[0]
            res["leapfrogs"] = int(b.last_run_leapfrogs.to_local()[0])
            res["eps"] = b.step_size.to_local().tolist()
            res["eps_rel_err"] = float(
                ((b.step_size.to_local() - a.step_size).abs()
                 / a.step_size.abs()).max())
        out[label] = res
        del a, b, want, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def state_rank_lockstep_runs(rank: int, dev, mesh) -> dict:
    """The lockstep samplers of :data:`STATE_LOCKSTEP_LEGS` on one rank of
    ``[state_mesh_ranks]``, each against unsharded chain by chain: in
    float32, and those of :data:`STATE_EXACT_LEGS` on float64 states (a
    chain of tempering, whose swaps move both runs, may first differ by a
    jump), with its kernel launches, the port's collectives and
    DTensor's, its density evaluations and its seconds; then ChEES
    ``warmed_up`` on float64 states at its leg's shape: the step size,
    trajectory length and positions against unsharded."""
    from torch.distributed.tensor.debug import CommDebugMode

    from mini_mcmc_torch.parallel import collectives, shard_sampler_state

    exact = {label: make for label, make, _ in
             state_lockstep_makes(dev, torch.float64)
             if label in STATE_EXACT_LEGS}
    out = {}
    for label, make, run_args in state_lockstep_makes(dev):
        make = exact.get(label, make)
        a = make()
        x0 = a.positions.clone()
        want = a.run(*run_args, time_major=True)
        b = make()
        b.state = shard_sampler_state(mesh, b.state, shard_state_dim=True)
        reset_counts()
        collectives.reset_counts()
        LOGP_CALLS[0] = 0
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            got = b.run(*run_args, time_major=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, coll = read_counts(), collectives.counts()
        local = got.to_local()
        w = local.shape[2]
        block = want[:, :, rank * w:(rank + 1) * w]
        share, decided = _chains_decided(
            block, local, x0[None, :, rank * w:(rank + 1) * w],
            merges=label == "tempering")
        out[f"lockstep_{label}"] = dict(
            share=share, decided=decided, dtype=str(local.dtype)[6:],
            max_err=float((local - block).abs().max()),
            moved=(local[1:] != local[:-1]).any(dim=2).tolist(),
            local=tuple(local.shape), d0=rank * w, dim=b.dim,
            launches={k: v for k, v in counts.items() if v},
            collectives={k: v for k, v in coll.items() if v},
            dtensor_all_reduces=sum(
                n for op, n in comm.get_comm_counts().items()
                if "all_reduce" in str(op)),
            evaluations=LOGP_CALLS[0], steps=sum(run_args),
            seconds=seconds)
        del a, b, want, got
        torch.cuda.empty_cache()
    make = state_lockstep_makes(dev, torch.float64)[0][1]  # ChEES-HMC
    a, b = make(), make()
    b.state = shard_sampler_state(mesh, b.state, shard_state_dim=True)
    t0 = time.perf_counter()
    ta = a.warmed_up(STATE_CHEES_WARMUP)
    torch.cuda.synchronize()
    seconds_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    tb = b.warmed_up(STATE_CHEES_WARMUP)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    local = tb.positions.to_local()
    w = local.shape[1]
    out["lockstep_chees_warmed"] = dict(
        eps=(ta.step_size, tb.step_size),
        traj_len=(ta.traj_len, tb.traj_len),
        split=tb._layout is not None and tb._layout.state is not None,
        max_err=float((local - ta.positions[:, rank * w:(rank + 1) * w])
                      .abs().max()),
        seconds=seconds, unsharded_s=seconds_a)
    del a, b, ta, tb
    torch.cuda.empty_cache()
    return out


def _state_rank_child(rank, world, init_method, device, chains, dim, out):
    try:
        out.put((rank, None, state_rank_runs(rank, world, init_method,
                                             device, chains, dim)))
    except BaseException:  # reported to the parent, which raises
        import traceback
        out.put((rank, traceback.format_exc(), None))


def spawn_state_ranks(tmp: str, device: str, chains: int, dim: int,
                      timeout: float) -> list:
    """:func:`state_rank_runs` on ``STATE_RANKS`` spawned processes, joined
    through a rendezvous file under ``tmp``; the ranks' results in rank
    order. A rank's error, or a group past ``timeout`` seconds, raises;
    every child is stopped on the way out."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init = "file://" + os.path.join(tmp, "state_ranks_rendezvous")
    procs = [ctx.Process(target=_state_rank_child,
                         args=(r, STATE_RANKS, init, device, chains, dim,
                               out))
             for r in range(STATE_RANKS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < STATE_RANKS:
            try:
                rank, err, res = out.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(
                    f"check FAILED [state ranks within {timeout} s]: "
                    f"{sorted(results)} answered") from None
            check(f"state rank {rank} ran", err is None, err)
            results[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(STATE_RANKS)]


def check_state_ranks(results: list, chains: int, dim: int) -> dict:
    """The checks of ``[state_mesh_ranks]`` on the ranks' results: the
    blocks, one decision per chain on every shard, the launches (the
    two-pass Kernel 7 each separable step, no kernel in lockstep) and the
    collectives (one all-reduce a step of the port's own, nothing else).
    Returns the separable path's launches on rank 0."""
    w = dim // STATE_RANKS
    for label, run_args in (("separable", STATE_RANK_SEP_RUN),
                            ("lockstep", STATE_RANK_LOCKSTEP_RUN)):
        steps = sum(run_args)
        rs = [r[label] for r in results]
        share = min(r["share"] for r in rs)
        one_decision = all(r["moved"] == rs[0]["moved"] for r in rs)
        say("state_mesh_ranks", path=label, ranks=STATE_RANKS,
            chains=chains, D=dim, local=rs[0]["local"],
            d0=",".join(str(r["d0"]) for r in rs),
            placements=rs[0]["placements"], chains_equal_share=repr(share),
            max_abs_err=repr(max(r["max_err"] for r in rs)),
            one_decision_per_chain=one_decision,
            differing_chains_flipped=all(r["flips_only"] for r in rs),
            launches=repr(rs[0]["launches"]).replace(" ", ""),
            collectives=repr(rs[0]["collectives"]).replace(" ", ""),
            seconds=repr(max(r["seconds"] for r in rs)))
        check(f"state ranks {label} blocks", all(
            r["local"] == (run_args[0], chains, w) and r["d0"] == i * w
            for i, r in enumerate(rs)), [r["local"] for r in rs])
        check(f"state ranks {label} chains equal unsharded",
              share >= STATE_RANK_SHARE, share)
        check(f"state ranks {label} one decision per chain", one_decision,
              label)
        check(f"state ranks {label} differing chains differ at a flipped "
              "decision", all(r["flips_only"] for r in rs), label)
        check(f"state ranks {label} one all-reduce a step", all(
            r["collectives"] == {"all_reduce": steps} for r in rs),
            [r["collectives"] for r in rs])
    for r in results:
        check("state ranks separable: the two-pass Kernel 7 each step",
              r["separable"]["launches"] == {
                  "hmc_separable": sum(STATE_RANK_SEP_RUN)},
              r["separable"]["launches"])
        check("state ranks lockstep launches no kernel",
              not any(r["lockstep"]["launches"].get(k) for k in KERNELS),
              r["lockstep"]["launches"])
    check_state_rank_samplers(results, chains, dim)
    check_state_rank_lockstep(results)
    return results[0]["separable"]["launches"]


def check_state_rank_samplers(results: list, chains: int, dim: int) -> None:
    """The checks of this slice's split samplers in ``[state_mesh_ranks]``:
    the blocks; MH and NUTS (float32, no adaptation) equal unsharded on at
    least ``STATE_RANK_SHARE`` of chains, the others first differing at
    a flipped decision; SGLD bit for bit; NUTS under adaptation (float64)
    within ``STATE_ADAPT_ATOL`` on every chain and its step sizes within
    1e-6; every shard of a chain moving in the same steps (and, NUTS,
    holding the same step sizes); no kernel; the collectives: MH two
    all-reduces a step (DTensor's: the logp and both q terms), SGLD none,
    NUTS between one and two of the port's state-axis sums a target
    evaluation, besides the chain axis's scalar loop exits."""
    w = dim // STATE_RANKS
    for label in ("mh", "sgld", "nuts", "nuts_adapt"):
        rs = [r[label] for r in results]
        share = min(r["share"] for r in rs)
        one_decision = all(r["moved"] == rs[0]["moved"] for r in rs)
        coll = rs[0]["collectives"]
        sums = coll.get("all_reduce", 0) - coll.get("all_reduce_scalar", 0)
        extra = {}
        if label.startswith("nuts"):
            one_decision = one_decision and all(r["eps"] == rs[0]["eps"]
                                                for r in rs)
            extra = dict(leapfrogs=rs[0]["leapfrogs"],
                         evaluations=rs[0]["evaluations"],
                         state_sums=sums, sums_per_evaluation=repr(
                             sums / max(rs[0]["evaluations"], 1)),
                         eps_rel_err=repr(max(r["eps_rel_err"]
                                              for r in rs)))
        say("state_mesh_ranks", path=label, ranks=STATE_RANKS,
            chains=chains, D=dim, local=rs[0]["local"],
            d0=",".join(str(r["d0"]) for r in rs),
            chains_equal_share=repr(share),
            chains_close_share=repr(min(r["close_share"] for r in rs)),
            max_abs_err=repr(max(r["max_err"] for r in rs)),
            one_decision_per_chain=one_decision,
            differing_chains_decided=all(r["decided"] for r in rs),
            launches=repr(rs[0]["launches"]).replace(" ", ""),
            collectives=repr(coll).replace(" ", ""),
            dtensor_all_reduces=rs[0]["dtensor_all_reduces"],
            steps=rs[0]["steps"], seconds=repr(max(r["seconds"]
                                                  for r in rs)), **extra)
        check(f"state ranks {label} blocks", all(
            r["local"][1:] == (chains, w) and r["d0"] == i * w
            for i, r in enumerate(rs)), [r["local"] for r in rs])
        check(f"state ranks {label} one decision per chain", one_decision,
              label)
        check(f"state ranks {label} launches no kernel", all(
            not any(r["launches"].get(k) for k in KERNELS) for r in rs),
            [r["launches"] for r in rs])
        check(f"state ranks {label} no all-gather or broadcast", all(
            not r["collectives"].get("all_gather")
            and not r["collectives"].get("broadcast") for r in rs),
            [r["collectives"] for r in rs])
        if label == "nuts_adapt":
            check("state ranks nuts_adapt every chain within "
                  f"{STATE_ADAPT_ATOL}", all(r["close_share"] == 1.0
                                             for r in rs),
                  [r["max_err"] for r in rs])
            check("state ranks nuts_adapt step sizes", all(
                r["eps_rel_err"] <= 1e-6 for r in rs),
                [r["eps_rel_err"] for r in rs])
        elif label == "sgld":
            check("state ranks sgld bit for bit", share == 1.0, share)
        else:
            check(f"state ranks {label} chains equal unsharded",
                  share >= STATE_RANK_SHARE, share)
            check(f"state ranks {label} differing chains differ at a "
                  "flipped decision", all(r["decided"] for r in rs), label)
        if label == "mh":
            check("state ranks mh two all-reduces a step", all(
                not r["collectives"] and r["dtensor_all_reduces"]
                == 2 * r["steps"] for r in rs),
                [(r["collectives"], r["dtensor_all_reduces"]) for r in rs])
        elif label == "sgld":
            check("state ranks sgld no collective", all(
                not r["collectives"] and not r["dtensor_all_reduces"]
                for r in rs), [r["collectives"] for r in rs])
        else:
            n = rs[0]["evaluations"]
            check(f"state ranks {label} at most two sums an evaluation",
                  n <= sums <= 2 * n and all(
                      not r["dtensor_all_reduces"] for r in rs),
                  (n, coll, rs[0]["dtensor_all_reduces"]))


def _lockstep_collectives(label: str, r: dict) -> bool:
    """A lockstep leg's collectives a step: ChEES-HMC one of the port's
    state-axis all-reduces (its logp a share, its gradient elementwise);
    the ensemble two (a logp a half) and tempering one (an inner sweep)
    of DTensor's; slice and elliptical one of DTensor's a density
    evaluation and the chain axis's scalar loop exits; no other kind."""
    coll, steps = r["collectives"], r["steps"]
    if coll.get("all_gather") or coll.get("broadcast"):
        return False
    if label == "chees":
        return coll == {"all_reduce": steps} and not r["dtensor_all_reduces"]
    if label in ("ensemble", "tempering"):
        per = 2 if label == "ensemble" else 1
        return not coll and r["dtensor_all_reduces"] == per * steps
    return (coll.get("all_reduce", 0) == coll.get("all_reduce_scalar", 0)
            and r["dtensor_all_reduces"] == r["evaluations"])


def check_state_rank_lockstep(results: list) -> None:
    """The checks of the lockstep legs in ``[state_mesh_ranks]``: the
    blocks and the global D; the chains equal unsharded on at least
    ``STATE_RANK_SHARE`` of chains, each other first differing at a
    flipped decision, and on every chain for :data:`STATE_EXACT_LEGS`;
    every shard of a chain moving in the same steps; no kernel; the
    collectives (:func:`_lockstep_collectives`); ChEES's
    float64 warm-up within ``STATE_ADAPT_ATOL`` of unsharded, its step
    size and trajectory length within 1e-6 and the same on both ranks."""
    for label, c, d, run_args in STATE_LOCKSTEP_LEGS:
        rs = [r[f"lockstep_{label}"] for r in results]
        w = d // STATE_RANKS
        share = min(r["share"] for r in rs)
        one_decision = all(r["moved"] == rs[0]["moved"] for r in rs)
        coll_ok = all(_lockstep_collectives(label, r) for r in rs)
        least = 1.0 if label in STATE_EXACT_LEGS else STATE_RANK_SHARE
        say("state_mesh_ranks", path=f"lockstep_{label}", ranks=STATE_RANKS,
            chains=c, D=d, dtype=rs[0]["dtype"], local=rs[0]["local"],
            d0=",".join(str(r["d0"]) for r in rs),
            chains_equal_share=repr(share),
            max_abs_err=repr(max(r["max_err"] for r in rs)),
            one_decision_per_chain=one_decision,
            differing_chains_decided=all(r["decided"] for r in rs),
            launches=repr(rs[0]["launches"]).replace(" ", ""),
            collectives=repr(rs[0]["collectives"]).replace(" ", ""),
            dtensor_all_reduces=rs[0]["dtensor_all_reduces"],
            evaluations=rs[0]["evaluations"], steps=rs[0]["steps"],
            seconds=repr(max(r["seconds"] for r in rs)))
        check(f"state ranks {label} blocks", all(
            r["local"] == (sum(run_args), c, w) and r["d0"] == i * w
            and r["dim"] == d for i, r in enumerate(rs)),
            [(r["local"], r["dim"]) for r in rs])
        check(f"state ranks {label} chains equal unsharded",
              share >= least, (share, rs[0]["dtype"]))
        check(f"state ranks {label} differing chains differ at a flipped "
              "decision", all(r["decided"] for r in rs), label)
        check(f"state ranks {label} one decision per chain", one_decision,
              label)
        check(f"state ranks {label} launches no kernel", all(
            not any(r["launches"].get(k) for k in KERNELS) for r in rs),
            [r["launches"] for r in rs])
        check(f"state ranks {label} collectives", coll_ok,
              [(r["collectives"], r["dtensor_all_reduces"],
                r["evaluations"]) for r in rs])
    rs = [r["lockstep_chees_warmed"] for r in results]
    rel = max(abs(r[k][1] - r[k][0]) / abs(r[k][0])
              for r in rs for k in ("eps", "traj_len"))
    same = all(r["eps"][1] == rs[0]["eps"][1]
               and r["traj_len"][1] == rs[0]["traj_len"][1] for r in rs)
    _, c, d, _ = STATE_LOCKSTEP_LEGS[0]
    say("state_mesh_ranks", path="lockstep_chees_warmed", ranks=STATE_RANKS,
        chains=c, D=d, dtype="float64",
        n_adapt=STATE_CHEES_WARMUP, eps=repr(rs[0]["eps"][1]),
        traj_len=repr(rs[0]["traj_len"][1]), rel_err=repr(rel),
        same_on_every_rank=same,
        max_abs_err=repr(max(r["max_err"] for r in rs)),
        seconds=repr(max(r["seconds"] for r in rs)),
        unsharded_s=repr(max(r["unsharded_s"] for r in rs)))
    check("state ranks chees warmed_up split", all(r["split"] for r in rs),
          rs)
    check("state ranks chees warmed_up eps and traj_len within 1e-6",
          rel <= 1e-6, rel)
    check("state ranks chees warmed_up the same on every rank", same, rs)
    check(f"state ranks chees warmed_up within {STATE_ADAPT_ATOL}",
          all(r["max_err"] <= STATE_ADAPT_ATOL for r in rs),
          [r["max_err"] for r in rs])


def phase_state_mesh_ranks(tmp: str) -> dict:
    """``[state_mesh_ranks]`` (42b): :func:`spawn_state_ranks` at the
    separable stage's 1,024 x 10,000, L = 10, both ranks on the one card,
    checked by :func:`check_state_ranks`; within ``STATE_RANKS_S``."""
    t0 = time.perf_counter()
    results = spawn_state_ranks(tmp, "cuda", SEP_CHAINS, SEP_DIM,
                                STATE_RANKS_S)
    launches = check_state_ranks(results, SEP_CHAINS, SEP_DIM)
    seconds = time.perf_counter() - t0
    say("state_mesh_ranks_times", seconds=repr(seconds),
        limit_s=STATE_RANKS_S)
    check(f"state mesh ranks within {STATE_RANKS_S} s",
          seconds <= STATE_RANKS_S, seconds)
    return {"launches": launches["hmc_separable"], "seconds": seconds}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also time five more runs and profile one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing run")
    # checkpoints, exports and traces, removed at the end
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run_phases(args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(args, tmp: str) -> None:
    dev = torch.device("cuda", 0)
    phase_device()
    reqs = user_requests(dev)
    reqs5678 = k5678_user_requests(dev)
    reqs64, reqs32 = f64_int32_requests(dev)
    so, reported = phase_build(reqs + reqs5678 + reqs64 + reqs32
                               + example_requests(dev))
    user_build = phase_user_build(reqs)
    phase_k5678_user_build(reqs5678 + reqs32)
    ptx64 = phase_f64_build(reqs64, reported)
    if args.profile:
        phase_sass(so, reported)
    phase_philox(dev)
    hmc, counts, tier_counts = phase_main_path(dev)
    lf = phase_leapfrog(hmc.target, hmc.state, dev)
    ms_err = phase_multistep(hmc.target, hmc.state, dev)
    phase_multistep(hmc.target, hmc.state, dev, label="multistep_chain0",
                    chain0=PAR_CHAIN0)
    t = phase_times(hmc, dev)
    k12w = phase_whitened_hmc(hmc, dev)
    if args.profile:
        phase_profile(hmc, dev)
    ckpt, saved = phase_checkpoint_flagship(hmc, dev, tmp)
    phase_checkpoint_device(ckpt, saved, dev)
    phase_trace(hmc, dev, tmp)
    del hmc, saved
    torch.cuda.empty_cache()
    progress_cube, run_cube, _ = phase_run_progress(dev)
    if args.profile:
        phase_runs_profile((
            ("tracked", lambda: tracked_run(flagship(dev), N_COLLECT,
                                            N_COLLECT, True)),
            ("run_progress", lambda: flagship(dev).run_progress(
                N_COLLECT, N_COLLECT, time_major=True,
                stream=io.StringIO()))))
    stream_launches = phase_stream_run(run_cube, dev)
    del run_cube
    phase_summary_on_card(progress_cube, dev)
    phase_io(progress_cube[:IO_DRAWS, :IO_CHAINS].transpose(0, 1)
             .contiguous(), tmp)
    del progress_cube
    torch.cuda.empty_cache()
    ml, mala_counts, _ = phase_mala_tuned(dev)
    k2m = phase_mala_kernel(ml, dev, args.profile)
    if args.profile:
        phase_runs_profile((("mala", lambda: ml.run(
            MALA_COLLECT, 0, time_major=True)),))
    del ml
    torch.cuda.empty_cache()
    nuts, nuts_m, nuts_counts, nuts_tier_counts = phase_nuts_main_path(dev)
    tuned, dense_m, dense_counts, dense_tier_counts = (
        phase_nuts_dense_metric(nuts, dev))
    sub_err, sub_leaves, sub_per_leaf = phase_subtree(nuts, dev)
    subtree_case(nuts, dev, 4, label="subtree_chain0", chain0=PAR_CHAIN0)
    k3_us = phase_k3_alone(nuts, dev) if args.profile else None
    step_err, step_details, step_args = phase_nuts_step(nuts, dev)
    phase_nuts_step(nuts, dev, "nuts_step_chain0", PAR_CHAIN0)
    t.update(phase_nuts_times(nuts, dev, step_args))
    k34w = phase_whitened_nuts(tuned, dev, args.profile)
    if args.profile:
        phase_nuts_profile(nuts, step_args)
        phase_runs_profile((("nuts_dense_metric", lambda: tuned.run(
            NUTS_COLLECT, NUTS_DISCARD)),))
    phase_checkpoint_nuts(nuts, tuned, dev, tmp)
    del nuts, tuned
    torch.cuda.empty_cache()
    nuts_c, nc_m, nc_counts = phase_nuts_constrained(dev)
    k1234t = phase_k1234_transformed(nuts_c, dev)
    del nuts_c
    torch.cuda.empty_cache()
    funnel = phase_funnel_kernels(dev)
    mh, mh_counts = phase_mh_main_path(dev)
    k5 = {"gauss2d": phase_mh_kernel(mh, "gauss2d", MH_K, 0x5EED_0808)}
    phase_mh_kernel(mh, "gauss2d_chain0", MH_K, 0x5EED_0808,
                    chain0=PAR_CHAIN0)
    pois, pois_counts = phase_poisson_main_path(dev)
    k5["poisson"] = phase_mh_kernel(pois, "poisson", POISSON_K, 0x5EED_4242)
    g, gibbs_counts = phase_gibbs_main_path(dev)
    k6 = phase_gibbs_kernel(g, 0x5EED_3232)
    phase_gibbs_kernel(g, 0x5EED_3232, chain0=PAR_CHAIN0)
    say("mh_gibbs_times", shape=f"C={MH_CHAINS},gauss2d K={MH_K},poisson "
        f"K={POISSON_K},gibbs K={GIBBS_K}",
        **{f"{p}_{k}": repr(v) for p, r in (*k5.items(), ("gibbs", k6))
           for k, v in r.items() if k != "err"})
    if args.profile:
        phase_k56_alone(dev)
        phase_runs_profile((
            ("mh", lambda: mh.run(MH_COLLECT, 0, time_major=True)),
            ("poisson", lambda: pois.run(POISSON_COLLECT, POISSON_DISCARD)),
            ("gibbs", lambda: g.run(GIBBS_COLLECT, 0, time_major=True))))
    phase_checkpoint_kernels(
        "mh", mh, lambda: mt.MetropolisHastings(
            mh.target, mh.proposal, mh.positions, use_pallas="full",
            steps_per_call=MH_K).seed(99), MH_K, {"mh_multistep": 1}, tmp)
    phase_checkpoint_kernels(
        "gibbs", g, lambda: mt.GibbsSampler(
            g.conditional, g.positions, use_pallas="full",
            steps_per_call=GIBBS_K).seed(99), GIBBS_K,
        {"gibbs_multistep": 1}, tmp)
    del mh, pois, g
    torch.cuda.empty_cache()
    mht, mht_counts, _ = phase_mh_tuned(dev)
    k5t = phase_mh_kernel(mht, "gauss2d_tuned", MH_K, 0x5EED_0909)
    say("mh_tuned_times", shape=f"C={MH_CHAINS},gauss2d K={MH_K}",
        **{k: repr(v) for k, v in k5t.items() if k != "err"})
    if args.profile:
        phase_runs_profile((("mh_tuned", lambda: mht.run(
            MH_COLLECT, 0, time_major=True)),))
    del mht
    torch.cuda.empty_cache()
    sep, sep_counts, _ = phase_sep_main_path(dev)
    sep40 = phase_sep_l40(dev)
    k7 = phase_sep_kernel(sep, dev)
    sep_step_check(sep.target, sep.state.positions, sep.state.logp, SEP_EPS,
                   "sep_step_chain0", chain0=PAR_CHAIN0)
    if args.profile:
        phase_runs_profile((("sep", lambda: sep.run(
            SEP_COLLECT, SEP_COLLECT, time_major=True)),),
            sep_steps=2 * SEP_COLLECT)
    phase_checkpoint_kernels(
        "separable", sep, lambda: mt.HMC(
            sep.target, sep.positions, SEP_EPS, SEP_L,
            use_pallas="separable").seed(99), CKPT_SEP_RUN,
        {"hmc_separable_step": CKPT_SEP_RUN}, tmp)
    del sep
    torch.cuda.empty_cache()
    warm, warm_counts, _ = phase_sep_warmed_up(dev)
    k7s = phase_sep_scaled_kernel(warm, dev)
    if args.profile:
        k7s["device_us"] = phase_k7_alone(dev)
        phase_runs_profile((("sep_warmed_up", lambda: warm.run(
            SEP_COLLECT, SEP_COLLECT, time_major=True)),),
            sep_steps=2 * SEP_COLLECT)
    del warm
    torch.cuda.empty_cache()
    sepc, sepc_counts, _, k7t = phase_sep_constrained(dev)
    if args.profile:
        # the stage's run; then 256 steps that record 8 rows, so that the
        # per-step check does not count each recorded row's map to x (a
        # few [C, D] passes a row, 128 rows a run)
        phase_runs_profile((("sep_constrained", lambda: sepc.run(
            SEP_COLLECT, SEP_COLLECT, time_major=True)),))
        phase_runs_profile((("sep_constrained_steps", lambda: sepc.run(
            8, 2 * SEP_COLLECT - 8, time_major=True)),),
            sep_steps=2 * SEP_COLLECT)
    del sepc
    torch.cuda.empty_cache()
    pt, pt_counts, _ = phase_pt_main_path(dev)
    k8 = phase_pt_kernel(pt, 0x5EED_8888)
    phase_pt_kernel(pt, 0x5EED_8888, label="pt_kernel_chain0",
                    chain0=PAR_CHAIN0)
    say("pt_times", shape=f"C={PT_CHAINS},T={PT_TEMPS},K={PT_K},D=1",
        **{k: repr(v) for k, v in k8.items() if k != "err"})
    if args.profile:
        phase_runs_profile((("pt", lambda: pt.run(
            PT_COLLECT, 0, time_major=True)),))
    phase_checkpoint_kernels(
        "tempering", pt, lambda: mt.ParallelTempering(
            pt.target, pt.positions, betas=pt.betas, proposal_std=1.0,
            steps_per_call=PT_K, use_pallas="full").seed(99), PT_K,
        {"pt_multistep": 1}, tmp)
    del pt
    torch.cuda.empty_cache()
    mhc_counts, k5c, mhc = phase_mh_constrained(dev)
    phase_checkpoint_constrained(mhc, tmp)
    del mhc
    ptc_counts, k8c = phase_pt_constrained(dev)
    torch.cuda.empty_cache()
    phase_chees(dev)
    phase_ensemble(dev)
    phase_slice(dev)
    phase_elliptical(dev)
    progress_launches = phase_run_progress_samplers(dev)
    phase_eight_schools(dev)
    phase_user_probe(dev)
    es8f, es8m = phase_eight_schools_fused(dev)
    uk = phase_user_kernels(es8f["hand"], dev)
    phase_k4_user_alone(uk, es8f["hand"])
    del es8f
    torch.cuda.empty_cache()
    mhu, builtin_cube = phase_mh_user(dev)
    mhp = phase_mh_user_proposal(builtin_cube, dev)
    del builtin_cube
    torch.cuda.empty_cache()
    ptu = phase_pt_user(dev)
    gu = phase_gibbs_user(dev)
    torch.cuda.empty_cache()
    su = phase_sep_user(dev)
    torch.cuda.empty_cache()
    f64 = phase_f64_leapfrog(dev)
    hmc64 = phase_f64_hmc_tier(dev)
    mala64 = phase_f64_mala_tuned(dev)
    phase_f64_samplers(dev)
    torch.cuda.empty_cache()
    i32 = phase_mh_user_int32(dev)
    phase_eight_schools_chees(dev)
    phase_ais(dev)
    phase_smc(dev)
    grad_fn, post_mean, post_var = sg_regression(dev)
    phase_sgld(grad_fn, post_mean, post_var, dev)
    phase_psgld(dev)
    phase_sghmc(grad_fn, post_mean, post_var, dev)
    del grad_fn
    torch.cuda.empty_cache()
    par = phase_parallel(dev)
    torch.cuda.empty_cache()
    state_mesh = phase_state_mesh(dev)
    torch.cuda.empty_cache()
    state_ranks = phase_state_mesh_ranks(tmp)
    phase_example_nuts_steps(dev)
    examples = phase_examples()
    bigd = examples["counts"]
    torch.cuda.empty_cache()
    b = bounds(step_details, sub_leaves, k34w["details"], k1234t, funnel)
    ub = user_bounds(uk)
    b.update({f"{k}_user_{kind}": v for (k, kind), v in ub.items()})
    b.update(k5678_user_bounds())
    b["leapfrog_trajectory_f64"] = (f64["flagship"]["bound_ms"],
                                    f64["flagship"]["bound_by"])
    say("bounds", **{f"{k}_bound_ms": repr(v[0]) for k, v in b.items()},
        **{f"{k}_bound_by": v[1] for k, v in b.items()})

    def record(name, source, replaces, launches, err, ms, plain_ms, **more):
        bound_ms, bound_by = b[name]
        return {"name": name, "route": "cuda",
                "source": f"mini_mcmc_torch/csrc/{source}",
                "replaces": f"mini_mcmc_tpu/ops/pallas/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, **more}

    # "kernels": those the main paths launched, each with its path's
    # counts (reset just before the path, read just after its timed run);
    # Kernels 1 and 3 (the use_pallas=True tiers) are off those paths and
    # report their own tier runs
    kernels = [
        record("hmc_multistep", "hmc_multistep.cu", "hmc_full.py:86",
               counts["hmc_multistep"], ms_err, t["multistep_ms"],
               t["multistep_plain_ms"], ms_whitened=k12w["multistep_ms"],
               max_abs_err_whitened=k12w["multistep_err"],
               launches_whitened=k12w["multistep_launches"],
               bound_ms_whitened=b["hmc_multistep_whitened"][0],
               bound_by_whitened=b["hmc_multistep_whitened"][1],
               launches_run_progress=2 * N_COLLECT // STEPS_PER_CALL,
               launches_stream_run=stream_launches,
               launches_parallel=par["hmc"]["counts"]["hmc_multistep"],
               split_launches_equal=par["split"]["hmc_multistep"]),
        record("nuts_step", "nuts_full.cu", "nuts_full.py:48",
               nuts_counts["nuts_step"], step_err, t["nuts_step_ms"],
               t["nuts_step_plain_ms"],
               launches_examples=examples["nuts_step"],
               launches_run_progress=progress_launches["nuts"],
               split_launches_equal=par["split"]["nuts_step"]),
        record("nuts_step_dense_metric", "nuts_full.cu", "nuts_full.py:48",
               dense_counts["nuts_step"], k34w["err"], k34w["ms"],
               k34w["plain_ms"]),
        record("mh_multistep_gauss2d", "mh_multistep.cu", "mh_full.py:50",
               mh_counts["mh_multistep"], k5["gauss2d"]["err"],
               k5["gauss2d"]["ms"], k5["gauss2d"]["plain_ms"],
               device_ms=k5["gauss2d"]["device_ms"],
               launches_run_progress=progress_launches["mh"],
               split_launches_equal=par["split"]["mh_multistep"]),
        record("mh_multistep_poisson", "mh_multistep.cu", "mh_full.py:50",
               pois_counts["mh_multistep"], k5["poisson"]["err"],
               k5["poisson"]["ms"], k5["poisson"]["plain_ms"],
               device_ms=k5["poisson"]["device_ms"],
               launches_examples=examples["poisson_mh_mh_multistep"]),
        record("gibbs_multistep", "gibbs_multistep.cu", "gibbs_full.py:47",
               gibbs_counts["gibbs_multistep"], k6["err"], k6["ms"],
               k6["plain_ms"],
               launches_run_progress=progress_launches["gibbs"],
               split_launches_equal=par["split"]["gibbs_multistep"]),
        record("hmc_separable", "hmc_separable.cu", "hmc_bigd.py:177",
               sep_counts["hmc_separable_step"]
               + sep_counts["hmc_separable"], k7["err"], k7["ms"],
               k7["plain_ms"], launches_fused=sep_counts["hmc_separable_step"],
               launches_two_pass=sep_counts["hmc_separable"],
               ms_trajectory_only=k7["ms_trajectory_only"],
               bound_ms_trajectory_only=b["hmc_separable_trajectory"][0],
               launches_L40=sep40["separable"]["launches"],
               launches_examples=(bigd["hmc_separable_step"]
                                  - bigd["hmc_separable_step_transformed"]),
               ms_L40=k7["ms_L40"], plain_ms_L40=k7["plain_ms_L40"],
               bound_ms_L40=b["hmc_separable_L40"][0],
               bound_by_L40=b["hmc_separable_L40"][1],
               launches_run_progress=progress_launches["separable"],
               split_launches_equal=par["split"]["hmc_separable_step"],
               launches_state_mesh=state_mesh["launches"],
               launches_state_ranks=state_ranks["launches"],
               d_slices_equal={
                   f"{name}_{n}": ok
                   for name, by_n in state_mesh["split"].items()
                   for n, ok in by_n.items()}),
        record("pt_multistep", "pt_multistep.cu", "tempering_full.py:61",
               pt_counts["pt_multistep"], k8["err"], k8["ms"],
               k8["plain_ms"], device_ms=k8["device_ms"],
               launches_run_progress=progress_launches["pt"],
               launches_parallel=par["pt"]["counts"]["pt_multistep"],
               split_launches_equal=par["split"]["pt_multistep"]),
        record("hmc_multistep_mala", "hmc_multistep.cu", "hmc_full.py:86",
               mala_counts["hmc_multistep"], k2m["err"], k2m["ms"],
               k2m["plain_ms"]),
        record("mh_multistep_tuned", "mh_multistep.cu", "mh_full.py:50",
               mht_counts["mh_multistep"], k5t["err"], k5t["ms"],
               k5t["plain_ms"]),
        record("hmc_separable_scaled", "hmc_separable.cu", "hmc_bigd.py:177",
               warm_counts["hmc_separable_step_scaled"]
               + warm_counts["hmc_separable_scaled"], k7s["err"], k7s["ms"],
               k7s["plain_ms"],
               launches_two_pass=warm_counts["hmc_separable_scaled"],
               launches_unscaled=(warm_counts["hmc_separable_step"]
                                  - warm_counts["hmc_separable_step_scaled"]),
               ms_trajectory_only=k7s["ms_trajectory_only"],
               bound_ms_trajectory_only=b[
                   "hmc_separable_scaled_trajectory"][0]),
    ]
    if "device_us" in k7s:  # --profile: each instance and form alone
        kernels[-1].update({
            f"device_ms_{target}_{form}": us * 1e-3
            for target, forms in k7s["device_us"].items()
            for form, us in forms.items()})
    # this slice's transformed instances and the funnel's functor, each
    # with its path's counts
    kernels += [
        record("nuts_step_transformed", "nuts_full.cu", "nuts_full.py:48",
               nc_counts["nuts_step_transformed"], k1234t["nuts_step_err"],
               k1234t["nuts_step_ms"], k1234t["nuts_step_plain_ms"],
               ms_whitened=k1234t["nuts_step_whitened_ms"],
               plain_ms_whitened=k1234t["nuts_step_whitened_plain_ms"],
               max_abs_err_whitened=k1234t["nuts_step_whitened_err"],
               launches_whitened=k1234t["whitened_launches"],
               bound_ms_whitened=b["nuts_step_whitened_transformed"][0],
               bound_by_whitened=b["nuts_step_whitened_transformed"][1]),
        record("hmc_separable_transformed", "hmc_separable.cu",
               "hmc_bigd.py:177",
               sepc_counts["hmc_separable_step_transformed"], k7t["err"],
               k7t["positive_ms"], k7t["positive_plain_ms"],
               launches_two_pass=sepc_counts["hmc_separable_transformed"],
               launches_examples=bigd["hmc_separable_step_transformed"],
               ms_mixed=k7t["ms"], plain_ms_mixed=k7t["plain_ms"],
               ms_mixed_trajectory_only=k7t["ms_trajectory_only"],
               bound_ms_mixed=b["hmc_separable_mixed"][0],
               ms_scaled=k7t["scaled_ms"],
               plain_ms_scaled=k7t["scaled_plain_ms"],
               ms_scaled_trajectory_only=k7t["scaled_ms_trajectory_only"],
               max_abs_err_scaled=k7t["scaled_err"],
               bound_ms_scaled=b["hmc_separable_scaled_transformed"][0]),
        record("nuts_step_funnel", "nuts_full.cu", "nuts_full.py:48",
               funnel["launches"], funnel["err"], funnel["ms"],
               funnel["plain_ms"]),
        record("mh_multistep_transformed", "mh_multistep.cu",
               "mh_full.py:50", mhc_counts["mh_multistep_transformed"],
               k5c["err"], k5c["ms"], k5c["plain_ms"],
               device_ms=k5c["device_ms"]),
        record("pt_multistep_transformed", "pt_multistep.cu",
               "tempering_full.py:61", ptc_counts["pt_multistep_transformed"],
               k8c["err"], k8c["ms"], k8c["plain_ms"],
               device_ms=k8c["device_ms"]),
    ]
    off_path = [
        record("leapfrog_trajectory", "hmc_leapfrog.cu", "hmc.py:46",
               counts["leapfrog_trajectory"], lf[8][0], t["leapfrog_ms"],
               t["leapfrog_plain_ms"],
               tier_run_launches=tier_counts["leapfrog_trajectory"],
               ms_whitened=k12w["leapfrog_ms"],
               max_abs_err_whitened=k12w["leapfrog_err"],
               tier_run_launches_whitened=k12w["leapfrog_launches"],
               bound_ms_whitened=b["leapfrog_trajectory_whitened"][0],
               launches_mala_path=mala_counts["leapfrog_trajectory"],
               ms_mala=k2m["leapfrog_ms"],
               plain_ms_mala=k2m["leapfrog_plain_ms"],
               bound_ms_mala=b["leapfrog_trajectory_mala"][0],
               **({"device_ms_mala": k2m["leapfrog_device_us"] * 1e-3}
                  if "leapfrog_device_us" in k2m else {})),
        record("nuts_subtree", "nuts_subtree.cu", "nuts_subtree.py:243",
               nuts_counts["nuts_subtree"], sub_err, t["subtree_ms"],
               t["subtree_plain_ms"],
               tier_run_launches=nuts_tier_counts["nuts_subtree"],
               ms_whitened=k34w["subtree_ms"],
               max_abs_err_whitened=k34w["subtree_err"],
               tier_run_launches_whitened=dense_tier_counts["nuts_subtree"],
               launches_parallel=par["nuts"]["counts"]["nuts_subtree"],
               split_launches_equal=par["split"]["nuts_subtree"],
               bound_ms_by_j=[b[f"nuts_subtree_j{j}"][0] for j in range(6)],
               lane_iterations_per_leaf_by_j=[sub_per_leaf[j]
                                              for j in range(6)]),
    ]
    if k3_us is not None:  # --profile
        off_path[-1]["device_ms_by_j"] = [k3_us[j] * 1e-3 for j in range(6)]
    # the transformed instances of Kernels 1-3 and the funnel's Kernel 3,
    # off the main paths: their own counted runs
    off_path += [
        record("leapfrog_trajectory_transformed", "hmc_leapfrog.cu",
               "hmc.py:46", nc_counts["leapfrog_trajectory"],
               k1234t["leapfrog_err"], k1234t["leapfrog_ms"],
               k1234t["leapfrog_plain_ms"],
               tier_run_launches=k1234t["leapfrog_launches"]),
        record("hmc_multistep_transformed", "hmc_multistep.cu",
               "hmc_full.py:86", nc_counts["hmc_multistep"],
               k1234t["multistep_err"], k1234t["multistep_ms"],
               k1234t["multistep_plain_ms"],
               tier_run_launches=k1234t["multistep_launches"]),
        record("nuts_subtree_transformed", "nuts_subtree.cu",
               "nuts_subtree.py:243", nc_counts["nuts_subtree"],
               k1234t["subtree_err"], k1234t["subtree_ms"],
               k1234t["subtree_plain_ms"],
               tier_run_launches=k1234t["subtree_launches"]),
        record("nuts_subtree_funnel", "nuts_subtree.cu",
               "nuts_subtree.py:243", 0, funnel["subtree_err"],
               funnel["subtree_ms"], funnel["subtree_plain_ms"]),
    ]
    main, off = user_records(record, b, uk, es8m, user_build)
    kernels += main
    off_path += off
    main, off = k5678_user_records(record, mhu, mhp, ptu, gu, su)
    kernels += main
    off_path += off
    kernels += f64_int32_records(record, f64, hmc64, mala64, ptx64, i32)
    print(json.dumps({"kernels": kernels, "off_main_path": off_path}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
