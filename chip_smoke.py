"""Smoke run of the PyTorch port (evostencils_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root
    python3 chip_smoke.py --phases deep,deep-bf16   # the build and those
                                 # phases only ([time] labels), no result

Phases:
0. require a CUDA card; print its name and power limit;
1. build the port's CUDA kernels from the sources in this checkout;
2. check each 2D leg kernel's tile, halo, threads, blocks per SM and
   spills (``transfer.leg_info``) against the wrapper module's constants
   for every sweep count and window class; compare each leg with its plain
   PyTorch version on the card, at the 2D path's 4095^2 grid, a ragged
   1023x2047 one, the ragged 129x131 near the gate and the path's other
   levels (2047^2 .. 255^2), for 1..3 sweeps, with the path's stencil and
   taps and with an anisotropic stencil and asymmetric taps;
   time both at every level of the path (4095^2 .. 255^2), with the
   kernel's device time alone (queued behind a spin of the card) beside;
2a. [kernels] bf16 (phase kernels-bf16): the same for the legs' bf16
   storage form (rows 1-2 on bf16 grids, float32 compute): each
   instantiation's tile, halo, threads, blocks per SM, registers and
   spills (``transfer.leg_info(..., dtype=torch.bfloat16)``), both legs
   against their plain versions at every level of the path (4095^2 ..
   255^2) and at 129x131 for 1..3 sweeps within TOL_BF16_ULPS bf16 ulps
   of max|plain|, timed at every level of the path with bytes counted at
   2 a value;
3. [kernels3d] check each 3D leg kernel's block schedule, blocks per SM
   and spills (``wavefront3d.leg_info``) against the wrapper module's
   constants; compare each leg with its plain version at 255^3, at the
   ragged 65x127x255 and at the 127^3 and 63^3 levels of the 3D path, with
   relaxation factors that differ; time both at every level, with the
   kernel's device time alone (queued behind a spin of the card) beside;
4. [kernels-rbgs] check the single-pass sweep kernel's strip, block,
   blocks per SM and spills in both modes (``rbgs.sweep_info``) against
   the wrapper module's constants; compare the standalone sweep kernels
   with their plain versions (the fused red-black sweep and the
   single-pass sweep in its parity modes -1, 0 and 1, omega 1.15, an
   anisotropic stencil) at
   4095^2, the [evaluator] levels 1023^2, 511^2 and 255^2 and the ragged
   300x200, and time both, and one pass of one colour, at 4095^2 and
   those levels, with the kernel's device time alone and its share of
   the bound beside, as for every standalone kernel (time_standalone);
   [kernels-rr] the same for the standalone transfers
   (residual + restriction, prolongation + correction) at the same levels
   and 257x255;
5. drive the 2D path, the Poisson V(2,1) cycle on 4095^2 (levels 12->5,
   float32, as bench.py builds it), through make_cycle_loop; check the
   relative residual, the analytic solution and that every fused leg ran
   through its kernel and no standalone kernel ran;
6. solve the 2D problem to a 1e-5 residual reduction with the kernels and
   with the plain versions; the iteration counts must be equal and the
   residual histories agree to 1e-3 above the float32 residual floor;
6a. [kernels-loop] check each fused pass instantiation's tile, halo,
   threads, blocks per SM and spills (``transfer.leg_info``, both forms,
   1..6 sweeps, every window class built for them), and each row-only
   leg's (1..3 sweeps), against the wrapper module's constants; compare
   the fused passes and the row-only legs
   (``upleg_downleg_col``, ``presmooth_residual_rowrestrict``,
   ``prolong_correct_postsmooth``, ``upleg_downleg_fused``) with their
   plain versions at 4095^2, 1023x2047 and 1023^2 (where the passes of up
   to 4 sweeps, row-only 3, take the smaller window class), with the
   path's stencil and taps and with an anisotropic stencil and asymmetric
   taps: the legs for 1..3 sweeps, the fused passes for every (post, pre) in {1, 2, 3}^2, a
   different omega for every sweep; time the legs at every level of the
   path, 4095^2 to 255^2, with its sweeps (2 pre, 1 post) and the passes
   at 4095^2 and 2047^2 with
   3 (the path's) and 6 sweeps, the kernel's device time alone beside
   (``time_loop_kernels``);
6b. [main-fused] drive phase 5's cell and protocol in three more
   configurations, the switches restored afterwards: (a) loop fusion on,
   fused column transfers; (b) loop fusion on, row-only legs; (c) loop
   fusion off, row-only legs.  Each must launch exactly its legs (per
   200-cycle batch: (a) 801 down-legs, 199 fused passes, 801 up-legs;
   (b) the same in row-only form; (c) 1000 row-only legs each way) and
   pass phase 5's residual and analytic checks; K = 1, 2 and 8 fused
   cycles must match K steps within 3e-5 max|u|; the row-only solve to
   1e-5 with the kernels and with the plain versions as phase 6.  The
   four configurations' ms/cycle (phase 5's is (d)) print on one line;
7. drive the 3D path, the Poisson V(2,1) cycle on 255^3 (levels 8->2,
   float32, as scripts/bench_suite.py builds its poisson3d_255cube row),
   as phase 5 drives the 2D one: each 3D leg must run through its kernel
   three times per cycle (255^3, 127^3 and 63^3);
8. the 3D solve to 1e-5, as phase 6;
9. [evaluator] the evolution path's evaluator: a CycleEvaluator on the
   card in float32 at poisson_2d(10, 5) (1023^2) runs measure_interleaved
   over the hand-built red-black V(2,1) (omega 1.15), the weighted-Jacobi
   V(2,1) (omega 0.8) and two stored champions of
   results/evolved_champions.json, each picked by its fitness; each of
   the four standalone kernels must launch, the Jacobi V(2,1) must launch
   9 sweeps, 3 residual restrictions and 3 prolongation corrections per
   cycle, every structure must take as many iterations to 1e-5 with the
   plain versions, with residual histories that agree to 1e-3 above the
   float32 floor of 1e-5 ||b||, and the gen-75 champion must converge
   faster than the red-black V(2,1);
10. [evolve] the CLI twin of scripts/optimize.py in this process,
   ``poisson2d NSGAII --mu 2 --lambda 2 --generations 1 --seed 0`` at
   its default levels 9->5, which must end with a finite best individual
   that re-parses and converges; its timing protocol takes one repetition
   of its windows instead of three, and it runs one generation of
   mu = lambda = 2 (8 initial candidates and 2 offspring), cuts of this
   run that keep the whole script near its time;
11. [kernels-sweep3d] check the red-black kernel's block schedule,
   blocks per SM and spills (``rbgs3d.sweep_info``) against the wrapper
   module's constants; compare the standalone 3D sweeps (red-black and
   Jacobi, omega 1.15, an anisotropic 7-point stencil) with their plain
   versions through the leg3d names at 255^3, 65x127x255 and 17x33x63 and
   through the rbgs3d names at 127^3, 63^3 and 12x40x200; time both at
   255^3, 127^3 and 63^3 (``time_3d_sweeps``), the device time alone and
   its share of the bound beside; [kernels-rr3d] the same for the 3D
   transfers (the residual restriction's ``leg3d.restrict_info``) with
   asymmetric per-axis taps at 255^3, 127^3, 63^3 and 65x127x255
   (``time_3d_transfers``);
12. [evaluator3d] a CycleEvaluator on the card in float32 at
   poisson_3d(8, 2) (255^3) runs measure_interleaved over the red-black
   V(2,1) and V(1,1) (omega 1.15) and the weighted-Jacobi V(2,1) (omega
   0.8); each of the six 3D standalone kernels must launch; per cycle the
   V(2,1) runs only the wavefront legs (3 + 3), the Jacobi V(2,1) 3
   leg3d and 6 rbgs3d Jacobi sweeps, 3 residual restrictions and 3
   prolongation corrections, the V(1,1) 1 leg3d and 2 rbgs3d red-black
   sweeps, 3 residual restrictions and 3 wavefront up-legs; kernels
   against plain versions as in [evaluator];
13. [evolve3d] ``poisson3d NSGAII --mu 2 --lambda 2 --generations 1
   --seed 0`` at its default levels 6->2 (63^3), cut to one generation as
   [evolve] and with the timing protocol off (one solve an evaluation,
   for the script's time); at least
   one 3D standalone kernel must launch;
14. [kernels-var] check each var leg instantiation's tile, halo, threads,
   blocks per SM and spills (``rbgs_var.leg_info``) against the wrapper
   module's constants for 1..3 sweeps, red-black and Jacobi, and the
   red-black sweep's (``rbgs_var.sweep_info``); compare the four
   variable-coefficient kernels (the fused red-black and the Jacobi
   sweep, the down-leg and the up-leg) with their plain versions at the
   main path's levels 2047^2, 1023^2, 511^2 and 255^2 with the
   variable-coefficient problem's own coefficient stack and at ragged
   shapes (1025x771 and 129x131 near the gate for the legs, 300x200 for
   the sweeps) with an anisotropic random stack, the legs for 1..3 sweeps,
   red-black and Jacobi; time both sweeps (``time_var_sweeps``) and the
   V(2,1)'s legs (2 sweeps down, 1 up), red-black and Jacobi
   (``time_var_legs``), at every level of the path, with the kernel's
   device time alone beside;
15. [main-var] drive the variable-coefficient path,
   poisson_2d_variable(11, 5) (2047^2, float32, the BASELINE suite's
   var-coef row, scripts/bench_suite.py:107-109, :127-129), with the
   weighted-Jacobi V(2,1) (omega 0.8) and the red-black V(2,1) (omega
   1.15), as phase 5 drives the 2D path: each var leg must run four times
   per cycle (2047^2 .. 255^2) and no other kernel at all; then each
   solve to 1e-5 as phase 6;
16. [evaluator-var] a CycleEvaluator at poisson_2d_variable(10, 5)
   (1023^2) runs measure_interleaved over the red-black and Jacobi V(2,1)
   and V(4,4); per cycle each runs 3 + 3 var legs, and each V(4,4) 6
   standalone var sweeps besides; kernels against plain versions as in
   [evaluator];
17. [evolve-var] ``poisson2d_var NSGAII --mu 2 --lambda 2 --generations 1
   --seed 0`` at its default levels 9->5 (511^2), cut as [evolve];
18. [kernels-sys] check the red-black sweep kernel's tile, halo, threads,
   blocks per SM and spills, with and without row fixups
   (``rbgs_sys.sweep_info``), against the wrapper module's constants;
   compare the four coupled-system kernels (the fused
   red-black and the Jacobi sweep, the down-leg and the up-leg) with their
   plain versions at 2047^2, 1023^2 and 255^2 with linear elasticity's own
   table, at 2047^2 and 255^2 with the split-complex Helmholtz operator's
   own table and point solve, whose Robin fold puts center and point-solve
   fixups on rows 0 and n - 1, and at ragged shapes (1025x771 for the
   legs, 300x200 and 65x130, which no sweep window divides, for the
   sweeps) with a random table whose point solve is not diagonal, row
   fixups and asymmetric taps, the legs for 1..3 sweeps, red-black and
   Jacobi; print each leg
   instantiation's halo, resident blocks per SM, registers, local memory
   and shared memory; time the sweeps at 2047^2
   and the V(2,1)'s legs (2 sweeps down, 1 up), red-black and Jacobi, at
   2047^2 and 255^2 (the level of [evaluator-elast] and [evolve-elast]),
   and the sweeps at those two levels too;
19. [main-elast] drive the elasticity path, linear_elasticity_2d(11, 4)
   (2047^2, float32, the BASELINE suite's elasticity row,
   scripts/bench_suite.py:111-113, :145-147), with the collective red-black
   V(2,1) (omega 1.25) and the collective Jacobi V(2,1) (omega 0.8), as
   phase 5 drives the 2D path: each system leg must run four times per
   cycle (2047^2 .. 255^2) and no other kernel at all; then each solve to
   1e-5 as phase 6;
20. [evaluator-elast] a CycleEvaluator at linear_elasticity_2d(8, 4)
   (255^2) runs measure_interleaved over the collective red-black and
   Jacobi V(2,1) and V(4,4), the decoupled red-black V(2,1) and the stored
   champion of lowest fitness_rho; per cycle each runs 1 + 1 system legs,
   each V(4,4) 2 standalone system sweeps and the champion 1 besides;
   kernels against plain versions as in [evaluator]; the champion needs no
   more iterations than the red-black V(2,1);
21. [evolve-elast] ``elasticity2d NSGAII --mu 2 --lambda 2 --generations 1
   --seed 0`` at its default levels 8->4 (255^2), cut as [evolve3d];
22. [kernels-cx] check the red-black complex sweep's kernel
   (``rbgs_cx.sweep_info``: tile, halo, threads, blocks per SM, spills)
   against the wrapper module's constants; compare the two complex sweep
   kernels (the fused red-black and the Jacobi sweep of a constant
   complex 5-point operator) with their plain versions at every level of
   the main path (2047^2 .. 255^2) with the shifted Laplacian's values at
   k = 80, at 2047^2 and 1023^2 with the JAX test's complex stencil too,
   and at the ragged 300x200 and 129x130 with the latter; time both
   sweeps at the main path's levels, with the kernel's device time alone
   beside;
23. [main-cx] drive the complex path: the shifted-Laplace preconditioner
   M = -Lap - k^2 (1 + 0.5i) with Dirichlet boundaries (k = 80, levels
   11->3, 2047^2 down to a dense 7^2 solve, complex64), built from the
   public IR as tests/test_pallas_cx.py:110-141 builds it, with the
   red-black V(2,1) and the Jacobi V(2,1) (omega 0.6), as phase 5 drives
   the 2D path: 12 sweeps of the cycle's kernel per cycle (3 on each of
   2047^2 .. 255^2) and no other kernel at all; then each solve to 1e-5
   as phase 6;
24. [helm] the family's own path: helmholtz_2d(7, 3) (127^2, the Robin
   operator) at k = 80, 160 and 320 in complex128, a preconditioned
   BiCGStab solve of the true operator to 1e-7 with one red-black V(2,1)
   (omega 0.6) per application, replayed from a CUDA graph as the
   evaluator replays it, whose iterations must lie within 2% of the JAX
   package's CPU float64 counts (BASELINE.md:251-262), and no kernel may
   launch; k = 80 once more in complex64, with its true relative
   residual, and again with the preconditioner eager: equal iterations
   and histories;
25. [evaluator-helm] a CycleEvaluator in float32 (complex64 fields) at
   helmholtz_2d(7, 3) runs measure_interleaved over the red-black and
   Jacobi V(2,1) and the 2 x 2 block-Jacobi V(2,1) (omega 0.6), each
   preconditioning BiCGStab; each must converge;
26. [evolve-helm] ``helmholtz2d NSGAII --mu 2 --lambda 2 --generations 1
   --seed 0 --no-robustness`` at its default levels 7->3 (127^2), cut as
   [evolve3d]; every evaluation is a BiCGStab solve, so the 2k and 4k
   robustness variants are cut too (EVOLVE_HELM_OPTIONS); each
   evaluation prints its BiCGStab iterations;
27. [main-split] drive the split-complex Helmholtz path:
   helmholtz_2d_split(11, 3) (2047^2 down to a dense 7^2 solve, float32,
   the BASELINE suite's Helmholtz row, scripts/bench_suite.py:115-121,
   :148-150) with the collective red-black V(2,1) and its Jacobi twin
   (omega 0.6), as phase 5 drives the 2D path but in batches of
   SPLIT_K_CYCLES: each system leg must run four times per cycle
   (2047^2 .. 255^2, each level once, counted by level in one step)
   with the problem's own fixup rows, and no other
   kernel at all; the varying point solve (``_pointwise_varying_inverse``)
   runs on 127^2 and below; then each solve to 1e-5 as phase 6; the
   device memory held at the peak is printed;
28. [helm-split] helmholtz_2d_split(7, 3) at k = 80, 160 and 320 in
   float64, the split BiCGStab to 1e-7 with one red-black V(2,1) (omega
   0.6) per application, replayed from a CUDA graph: its iterations must
   lie within 2% of [helm]'s complex128 counts of this run (the same
   algebra) at k = 80 and 160, within 5% at k = 320, where a float64
   run's count moves with its rounding (HELM_SPLIT_TOLERANCE), and no
   kernel may launch;
29. [evolve-split] ``helmholtz2d_split NSGAII --mu 2 --lambda 2
   --generations 1 --seed 18 --no-robustness`` at its default levels 7->3
   (127^2), cut as [evolve-helm] and to EVOLVE_SPLIT_MAX_ITERATIONS
   BiCGStab iterations an evaluation, with the peak device memory
   printed (seed 18: no candidate of seed 0 converges, in either
   package; EVOLVE_SPLIT_SEED);
30. [main-fas] drive the FAS path: fas_2d_basic(10, 6) (1023^2,
   float32, scripts/bench_suite.py:123-125, :151-152) with fas_v_cycle
   (damped Newton-Jacobi, omega 0.8, V(2,2), 200 Newton-Jacobi sweeps
   on the coarsest 63^2), chained in batches of FAS_K_CYCLES: the
   prolongation-correction kernel must run three times per cycle (1023^2,
   511^2 and 255^2, where the JAX lowering runs its Pallas
   ``prolong_row_correct``) and no other kernel; then the solves:
   float32 to FAS_TARGETS' reduction with the kernels and with the plain
   versions (equal iterations, histories within 1e-3 above the float32
   floor of the nonlinear residual) and float64 to 1e-5, where no kernel
   may launch (the gates take float32 only), each within 1 of the JAX
   package's CPU count (FAS_JAX_ITERATIONS), with the largest error
   against the analytic solution;
31. [evolve-fas] ``fas2d NSGAII --mu 2 --lambda 2 --generations 1 --seed
   0`` at EVOLVE_FAS_LEVELS (63^2, cut from 10->6) with a budget of
   EVOLVE_FAS_MAX_ITERATIONS cycles an evaluation, timing protocol off
   as [evolve3d];
32. [deep] the deep solve of scripts/deep_solve.py: poisson_2d(10, 4)
   (1023^2) with the red-black V(2,1) at omega 1.15 to 1e-12 by
   iterative refinement (compiler/refine: the residual and solution in
   float64, 8 float32 cycles an outer step), once with the kernels and
   once with the plain versions: both converge with equal outer counts
   and histories within 1e-3 above 1e-10 (deep_histories; above 1e-10
   that holds only the first correction's entry, which may also move by
   1e-5 of the entry before: [kernels] is what holds rows 1-2 to their
   plain versions), rows 1-2 run once per gated level and inner cycle and
   nothing else; the outer count, history, wall seconds and ms an inner
   cycle are printed;
33. [deep-fas] fas_2d_basic(10, 6) to 1e-10 by Newton steps of 3
   Richardson iterations, each preconditioned by 3 float32 cycles of the
   shifted linear operator L + 20 I (scripts/deep_solve.py:95-117),
   kernels against plain as [deep]; the shifted cycle runs rows 1-2;
34. [deep-bf16] [deep] with bf16 inner cycles (3 an outer step, at most
   16 outer steps): the contraction over each two consecutive outer
   steps below 0.2, the bf16 legs launched once per gated level and
   cycle, outer counts of kernels, plain versions and the JAX package's
   CPU run within 1;
35. [deep-split] helmholtz_2d_split(7, 3) in float32 to a TRUE relative
   residual of 1e-7 at k = 80 by the reliable-update BiCGStab
   (compiler/refine_split) and by the float64-basis one: the
   true residual recomputed in float64 from the returned solution at
   most 2e-7; the reliable solve's iterations at most 1.3 times the JAX
   package's CPU count of the same float32 solve (the count is
   rounding-bound), the float64-basis solve's at most 1.15 times
   [helm-split]'s float64 count + 10; no kernel launch;
36. [chunked] a level-chunked program on the card: poisson_2d(10, 5)
   (1023^2) with the reference RB V(2,1) at omega 1.15, lowered whole and
   split as --levels-per-run 3 splits it (chunk 0 on 1023^2, 511^2, 255^2;
   chunk 1 on 127^2 and 63^2 over the dense 31^2 solve) and composed
   (``lower_composed``): CHUNKED_CYCLES chained cycles of each must launch
   the same kernels the same number of times (rows 1-2 three times a
   cycle) with residual histories within CHUNKED_HIST_RTOL, and the
   composed program's solve to 1e-5 with the kernels and the plain
   versions as phase 6; ms a cycle of both;
37. [cg] chunk 0 of --levels-per-run 2 on the same hierarchy alone,
   1023^2 and 511^2 over a CG solve of 255^2 (65,025 unknowns, above
   DIRECT_SOLVE_MAX): its solve to 1e-5 as phase 6, CG iterations and host
   syncs a coarse solve, one CG solve alone timed, ms a cycle; then the
   V(2,1) whose coarse solve is CG_KRYLOV_ITERATIONS fixed CG iterations
   (``v_cycle(coarse_krylov="CG")``) against the dense coarse solve's, at
   most one cycle more to 1e-5 (tests/test_krylov.py:99-131);
38. [evolve-chunked] ``poisson2d NSGAII --mu 2 --lambda 2 --generations 1
   --seed 0`` with EVOLVE_CHUNKED_OPTIONS (levels 8 -> 4 in chunks of 2,
   the chunk boundary a dense 63^2 solve), timing protocol off; the best
   composed program, rebuilt from the chunk strings
   (``evaluate_chunked_program``), must converge, and so must the
   ``evaluate_evolved_solver`` twin's measurement of best_grammar.txt;
39. [lfa] Local Fourier Analysis on the card (batched complex128 tensor
   programs, no kernel of this repository): rho of the RB V(2,1) (omega
   1.15) and Jacobi V(2,1) (omega 0.8) at poisson_2d(9, 5) and of the
   collective RB V(2,1) (omega 1.25) at linear_elasticity_2d(8, 4), by the
   power method and by exact eigenvalues; exact within LFA_EXACT_TOL of
   the JAX package's value stored in LFA_CASES, power within
   LFA_POWER_RTOL of exact; ms per rho, peak device memory and host syncs
   per rho;
40. [evolve-model] ``poisson2d NSGAII --model-based --mu 2 --lambda 2
   --generations 1 --seed 0`` (9 -> 5): evaluations, wall time, seconds
   per estimate, no kernel launched; the best individual's estimate within
   EVOLVE_MODEL_RTOL of its exact rho, its measured rho printed beside;
41. [prescreen] the small-grid prescreen of 16 seeded individuals at
   9 -> 5 against poisson_2d(6, 2), float32, on the card and at the same
   time on the CPU (a child process, joined before the phase ends): equal
   verdicts, members near rho_cap named, the time on each device;
42. [procs] one evolution in 2 processes on the one card (``torchrun
   --standalone --nproc-per-node 2``, a gloo group, each rank
   ``cuda:0``) and in 1, each process this script's rank body
   (``--procs-rank``), which forms the group and runs
   ``optimize.main``: the model-based run of [evolve-model] (9 -> 5),
   then a measured run at 255^2 (``--max-level 8 --min-level 4``, timing
   protocol off); model-based, both ranks and the 1-process run end with
   the same population and best individual, fitness within
   PROCS_FITNESS_RTOL; measured, both ranks with the same population and
   a best individual that converges when re-evaluated here; evaluations,
   wall seconds and evaluations a second of each run;
43. [cma] the CMA-ES transfer-weight tuner on the card
   (``intergrid_transfer.optimize``, CMA_SETTINGS) on poisson_2d(8, 7)
   and poisson_2d_variable(8, 7): 255^2 over a dense float64 inverse of
   127^2 (16,129 unknowns); the tuned rho finite and no worse than the
   default pair's; seconds a generation, the inverse's seconds, peak
   device memory; at poisson_2d(6, 5) generation 0's fitness values on
   the card against the port's on the CPU (a spawned child) within
   CMA_CPU_RTOL;
44. [reference-cycles] the four hand-built V(2,2) fixtures
   (``ir/reference_cycles``) solved to 1e-5 in float32 with the kernels
   and with the plain versions as phase 6: the linear two-grid at 127^2
   over a dense 63^2 solve, the linear three-grid at 255^2, the FAS two-
   and three-grid at 31^2; rho under the JAX tests' bounds
   (REFERENCE_CYCLES); the kernels the 255^2 fixture launches;
45. check that neither jax nor the JAX package was imported.

The launch counts are set to 0 just before each path is driven (phases 5,
6b, 7, 9, 10, 12, 13, 15, 16, 17, 19, 20, 21, 23 to 26, 27 to 31, 32
to 35, each deep solve, 36 to 38, each program, 40, 41 and each fixture
of 44) and read just after.  Each phase prints
its seconds.  Any failed check raises, and the
script exits non-zero without printing its result line.  The last line of
standard output is {"ok": true, "device": {...}}; the line before it lists
each kernel with its launches on its path, its largest deviation from the
plain version, its time and the plain version's, and the least time the
card could take for the same work (bytes over 3.35 TB/s or float32
operations over 67 TFLOP/s, the larger).
"""

import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

K_CYCLES = 200            # chained cycles per batch (bench.py:72)
#: the split paths' chained cycles per batch, cut from K_CYCLES: a cycle
#: there takes 40-70 ms of host time, and the script its 1,200 s
SPLIT_K_CYCLES = 100
BATCHES = 4               # the first one warms up
WARMUP = 3
TIMED_REPS = 15
#: clock cycles the card spins before a queued timing (time_ms_queued):
#: about 1 ms, longer than a wrapper's host work before its launch
SPIN_CYCLES = 2_000_000
#: H100 SXM published peaks: HBM bytes/s and float32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: normalized 5-point and 7-point Laplacians and the paths' transfer taps
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
R_TAPS = ((0.25, 0.5, 0.25), (0.25, 0.5, 0.25))
P_TAPS = ((0.5, 1.0, 0.5), (0.5, 1.0, 0.5))
VALS7 = (6.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0)
R_TAPS3 = ((0.25, 0.5, 0.25),) * 3
P_TAPS3 = ((0.5, 1.0, 0.5),) * 3
#: an anisotropic stencil and asymmetric taps for the standalone
#: kernels' checks, so that a swapped axis or direction shows
ANISO = (5.0, -1.5, -0.5, -1.25, -0.75)
R_TAPS_ASYM = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3))
P_TAPS_ASYM = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5))
#: the 3D standalone kernels' checks: an anisotropic 7-point stencil and
#: per-axis taps that differ on every axis
ANISO7 = (7.0, -1.5, -0.5, -1.25, -0.75, -2.0, -1.0)
R_TAPS3_ASYM = ((0.2, 0.5, 0.3), (0.1, 0.6, 0.3), (0.3, 0.45, 0.25))
P_TAPS3_ASYM = ((0.4, 1.0, 0.6), (0.3, 0.9, 0.5), (0.7, 1.1, 0.2))
#: float32 reassociation slack: 2D (tests/test_fused_columns.py:52-53,
#: :81); 3D u (tests/test_wavefront3d.py:57-61) and rc; the standalone
#: sweeps (relative + absolute, tests/test_pallas_kernels.py:31-60) and
#: transfers (absolute)
TOL_U, TOL_RC = 1e-5, 1e-4
TOL_U3, TOL_RC3 = 2e-5, 1e-4
TOL_SWEEP, TOL_TRANSFER = 2e-6, 2e-5
ROOT = pathlib.Path(__file__).resolve().parent
KERNELS = {
    "presmooth_residual_restrict": (
        "evostencils_tpu/ops/pallas/transfer.py:810",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "prolong_correct_postsmooth_col": (
        "evostencils_tpu/ops/pallas/transfer.py:917",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    # rows 1-2 in bf16 storage: the TPU kernels on bf16 grids
    "presmooth_residual_restrict_bf16": (
        "evostencils_tpu/ops/pallas/transfer.py:810",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "prolong_correct_postsmooth_col_bf16": (
        "evostencils_tpu/ops/pallas/transfer.py:917",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "upleg_downleg_col": (
        "evostencils_tpu/ops/pallas/transfer.py:1045",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "presmooth_residual_rowrestrict": (
        "evostencils_tpu/ops/pallas/transfer.py:274",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "prolong_correct_postsmooth": (
        "evostencils_tpu/ops/pallas/transfer.py:390",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "upleg_downleg_fused": (
        "evostencils_tpu/ops/pallas/transfer.py:525",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "downleg_wavefront_3d": (
        "evostencils_tpu/ops/pallas/wavefront3d.py:220",
        "evostencils_tpu_torch/csrc/wavefront3d.cu"),
    "upleg_wavefront_3d": (
        "evostencils_tpu/ops/pallas/wavefront3d.py:391",
        "evostencils_tpu_torch/csrc/wavefront3d.cu"),
    "fused_rbgs_sweep": (
        "evostencils_tpu/ops/pallas/rbgs.py:213",
        "evostencils_tpu_torch/csrc/rbgs.cu"),
    "jacobi_sweep": (
        "evostencils_tpu/ops/pallas/rbgs.py:153",
        "evostencils_tpu_torch/csrc/rbgs.cu"),
    "residual_restrict": (
        "evostencils_tpu/ops/pallas/transfer.py:104",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "prolong_correct": (
        "evostencils_tpu/ops/pallas/transfer.py:174",
        "evostencils_tpu_torch/csrc/transfer.cu"),
    "fused_rbgs_sweep_3d": (
        "evostencils_tpu/ops/pallas/rbgs3d.py:181",
        "evostencils_tpu_torch/csrc/sweep3d.cu"),
    "jacobi_sweep_3d": (
        "evostencils_tpu/ops/pallas/rbgs3d.py:187",
        "evostencils_tpu_torch/csrc/sweep3d.cu"),
    "fused_rbgs_sweep_3d2": (
        "evostencils_tpu/ops/pallas/leg3d.py:186",
        "evostencils_tpu_torch/csrc/sweep3d.cu"),
    "jacobi_sweep_3d2": (
        "evostencils_tpu/ops/pallas/leg3d.py:209",
        "evostencils_tpu_torch/csrc/sweep3d.cu"),
    "residual_restrict_3d": (
        "evostencils_tpu/ops/pallas/leg3d.py:264",
        "evostencils_tpu_torch/csrc/leg3d.cu"),
    "prolong_correct_3d": (
        "evostencils_tpu/ops/pallas/leg3d.py:343",
        "evostencils_tpu_torch/csrc/leg3d.cu"),
    "fused_rbgs_sweep_var": (
        "evostencils_tpu/ops/pallas/rbgs_var.py:162",
        "evostencils_tpu_torch/csrc/rbgs_var.cu"),
    "jacobi_sweep_var": (
        "evostencils_tpu/ops/pallas/rbgs_var.py:168",
        "evostencils_tpu_torch/csrc/rbgs_var.cu"),
    "presmooth_residual_restrict_var": (
        "evostencils_tpu/ops/pallas/rbgs_var.py:269",
        "evostencils_tpu_torch/csrc/rbgs_var.cu"),
    "prolong_correct_postsmooth_var": (
        "evostencils_tpu/ops/pallas/rbgs_var.py:366",
        "evostencils_tpu_torch/csrc/rbgs_var.cu"),
    "fused_rbgs_sweep_sys": (
        "evostencils_tpu/ops/pallas/rbgs_sys.py:219",
        "evostencils_tpu_torch/csrc/rbgs_sys.cu"),
    "jacobi_sweep_sys": (
        "evostencils_tpu/ops/pallas/rbgs_sys.py:227",
        "evostencils_tpu_torch/csrc/rbgs_sys.cu"),
    "presmooth_residual_restrict_sys": (
        "evostencils_tpu/ops/pallas/rbgs_sys.py:357",
        "evostencils_tpu_torch/csrc/rbgs_sys.cu"),
    "prolong_correct_postsmooth_sys": (
        "evostencils_tpu/ops/pallas/rbgs_sys.py:459",
        "evostencils_tpu_torch/csrc/rbgs_sys.cu"),
    "fused_rbgs_sweep_cx": (
        "evostencils_tpu/ops/pallas/rbgs_cx.py:153",
        "evostencils_tpu_torch/csrc/rbgs_cx.cu"),
    "jacobi_sweep_cx": (
        "evostencils_tpu/ops/pallas/rbgs_cx.py:160",
        "evostencils_tpu_torch/csrc/rbgs_cx.cu"),
}
#: the standalone kernels, which the [evaluator] phase drives
STANDALONE = ("fused_rbgs_sweep", "jacobi_sweep", "residual_restrict",
              "prolong_correct")
#: the 3D standalone kernels, which the [evaluator3d] phase drives
STANDALONE3 = ("fused_rbgs_sweep_3d", "jacobi_sweep_3d",
               "fused_rbgs_sweep_3d2", "jacobi_sweep_3d2",
               "residual_restrict_3d", "prolong_correct_3d")
#: the variable-coefficient legs and standalone sweeps
VAR_LEGS = ("presmooth_residual_restrict_var",
            "prolong_correct_postsmooth_var")
VAR_SWEEPS = ("fused_rbgs_sweep_var", "jacobi_sweep_var")
#: the variable-coefficient kernels' float32 slack, relative to the
#: largest plain value: the problem's coefficients reach 3e7 at 2047^2,
#: so A u cancels terms of 1e8 whose rounding differs by a few units
TOL_VAR = 1e-5
#: the coupled-system legs and standalone sweeps
SYS_LEGS = ("presmooth_residual_restrict_sys",
            "prolong_correct_postsmooth_sys")
SYS_SWEEPS = ("fused_rbgs_sweep_sys", "jacobi_sweep_sys")
#: the system kernels' float32 slack, relative to the largest plain value:
#: elasticity's center coefficients reach 6e9 at 2047^2, so A u cancels
#: terms of that order, and the kernels contract multiply-adds
TOL_SYS = 1e-5
#: the complex sweeps
CX_SWEEPS = ("fused_rbgs_sweep_cx", "jacobi_sweep_cx")
#: the complex sweeps' complex64 slack, relative to the largest plain
#: value: the shifted Laplacian's center is 1.7e7 at 2047^2, so A u cancels
#: terms of that order, and the kernel contracts multiply-adds
TOL_CX = 1e-5
#: the JAX test's complex stencil (tests/test_pallas_cx.py:17)
VALS_CX = (4.0 - 0.5j, -1.0 + 0.02j, -1.0 + 0.02j, -1.0 - 0.01j,
           -1.0 - 0.01j)
#: float32 operations per point of a complex sweep: A u (5 complex
#: products of 6 operations, 8 sums), b - A u (2), d times it (6), omega
#: times that (2) and the update (2)
CX_SWEEP_FLOPS = 50


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(torch, fn):
    """Median milliseconds of one call, by CUDA events, after warm-up."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(TIMED_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_queued(torch, fn):
    """Median milliseconds of one call's device work, by CUDA events around
    the call queued behind a spin of the card (SPIN_CYCLES), so that the
    events do not count the wrapper's host work before its launch, which
    time_ms does."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(TIMED_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_pair(torch, kern, plain):
    """(kernel ms, plain ms, the four turns): plain, kernel, kernel, plain,
    so that both sides see the same card."""
    p1, k1, k2, p2 = (time_ms(torch, f) for f in (plain, kern, kern, plain))
    return statistics.median([k1, k2]), statistics.median([p1, p2]), \
        (p1, k1, k2, p2)


#: float32 operations per fine point of a leg besides its sweeps, in d
#: dimensions: the down-leg's residual (2d + 2) and separable restriction
#: (5 per output point of each axis pass: 5/2 + 5/4 (+ 5/8) per fine
#: point); the up-leg's separable prolongation (2 per point of each axis
#: pass: 2/4 + 2/2 + 2 in 3D, 2/2 + 2 in 2D) and correction (2)
LEG_FLOPS = {("down", 2): 6 + 3.75, ("up", 2): 3.0 + 2,
             ("down", 3): 8 + 4.375, ("up", 3): 3.5 + 2}


def bytes_bound(nbytes, flops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the float32 operations over its peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leg_bound(shape, sweeps, leg, itemsize=4):
    """(bound ms, "bytes" or "operations") of a leg on a fine grid of
    ``shape``: it must read u and b and write u once (``itemsize`` bytes
    a value: 4 in float32, 2 in bf16 storage), and move the coarse array
    (rc written or e read) once; it does ``sweeps``
    red-black sweeps (each point updated once per sweep: the off-diagonal
    products and sums and the premultiplied update, 2d + 6 flops in d
    dimensions) and the work of LEG_FLOPS."""
    d = len(shape)
    fine = int(np.prod(shape))
    coarse = int(np.prod([(n - 1) // 2 for n in shape]))
    nbytes = itemsize * (3 * fine + coarse)
    flops = fine * (sweeps * (2 * d + 6) + LEG_FLOPS[(leg, d)])
    return bytes_bound(nbytes, flops)


#: the 2D path's levels, where time_2d_legs times both legs
LEVELS_2D = (4095, 2047, 1023, 511, 255)


def time_2d_legs(torch, transfer, device, shape, stats=None, dtype=None,
                 tag="kernels"):
    """Both 2D legs of the V(2,1) (2 sweeps down, 1 up) at ``shape``:
    kernel and plain in turns as the other kernels are timed (time_pair),
    the numbers going to ``stats`` when it is given; the kernel's device
    time alone (time_ms_queued, without the wrapper's host work that
    time_pair counts) is logged beside them.  ``dtype``: the fields'
    storage (float32 unless given; bf16 stats go to the names with
    "_bf16").  Uses only the wrappers' public signatures, so it times an
    older tree's package as well (in float32)."""
    dtype = dtype or torch.float32
    suffix, itemsize = ("_bf16", 2) if dtype == torch.bfloat16 else ("", 4)
    rng = np.random.default_rng(3)
    n, m = shape
    u, b, e = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device=device).to(dtype)
               for s in (shape, shape, ((n - 1) // 2, (m - 1) // 2)))
    omegas = torch.tensor([0.9, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    timed = {
        "presmooth_residual_restrict": (
            lambda: transfer.presmooth_residual_restrict(
                u, b, omegas, [1, 2], VALS, R_TAPS),
            lambda: transfer.presmooth_residual_restrict_plain(
                u, b, omegas, [1, 2], VALS, R_TAPS),
            leg_bound(shape, 2, "down", itemsize)),
        "prolong_correct_postsmooth_col": (
            lambda: transfer.prolong_correct_postsmooth_col(
                u, e, b, omegas, [0, 1], VALS, P_TAPS),
            lambda: transfer.prolong_correct_postsmooth_col_plain(
                u, e, b, omegas, [0, 1], VALS, P_TAPS),
            leg_bound(shape, 1, "up", itemsize)),
    }
    size = "x".join(map(str, shape))
    for name, (kern, plain, (bound, by)) in timed.items():
        k, p, turns = time_pair(torch, kern, plain)
        log(f"[{tag}] {name}{suffix} {size}: kernel {turns[1]:.4f}/"
            f"{turns[2]:.4f} ms, plain {turns[0]:.4f}/{turns[3]:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); kernel queued "
            f"{time_ms_queued(torch, kern):.4f} ms")
        if stats is not None:
            stats[name + suffix].update(ms=k, plain_ms=p, bound_ms=bound,
                                        bound_by=by)


def check_leg2d_info(transfer, tag="kernels",
                     legs=(("down", (1, 2, 3)), ("up", (1, 2, 3))),
                     **dtype):
    """Each instantiation of the windowed 2D kernels ``legs`` ((leg, sweep
    counts) pairs) in every window class built for it: its tile, halo,
    threads, blocks per SM, registers, local memory (spills) and shared
    memory, from the card.  Tile, halo and threads must be the wrapper
    module's; at least the blocks per SM that its window rule counts on
    must be resident (its __launch_bounds__ ask for them; an instantiation
    that needs fewer registers may fit more); nothing may spill.
    ``dtype``: the storage type's keyword for ``leg_info`` (the bf16 legs';
    none for float32, which an older tree's package takes too)."""
    for leg, counts in legs:
        for sweeps in counts:
            for window in transfer.leg_windows(leg, sweeps):
                i = transfer.leg_info(leg, sweeps, window, **dtype)
                log(f"[{tag}] {leg} S={sweeps} window {window}: tile "
                    f"{i['tile_rows']}x{i['tile_cols']}, halo {i['halo']}, "
                    f"{i['threads']} threads, {i['blocks_per_sm']} "
                    f"blocks/SM, {i['registers']} registers, "
                    f"{i['local_bytes']} B local, {i['smem_bytes']} B "
                    "shared")
                tile = transfer.leg_tile(leg, sweeps, window)
                want = {"tile_rows": tile[0], "tile_cols": tile[1],
                        "halo": transfer.leg_halo(leg, sweeps),
                        "threads": transfer.WINDOWS[window][2],
                        "local_bytes": 0}
                blocks = transfer.leg_blocks(leg, window)
                check(all(i[k] == v for k, v in want.items())
                      and i["blocks_per_sm"] >= blocks,
                      f"2D {leg} S={sweeps} window {window} info {i} "
                      f"against the wrapper's {want}, {blocks} blocks/SM")


#: the shapes where the 2D legs are held against their plain versions: the
#: path's finest level, a ragged level, a ragged shape near the gate, and
#: the path's other levels (from 1023^2 down, the smaller window class)
CHECK_2D = ([(4095, 4095), (1023, 2047), (129, 131)]
            + [(n, n) for n in LEVELS_2D[1:]])


def phase_kernels(torch, transfer, device):
    """Each 2D kernel against its plain version at every shape of CHECK_2D
    and sweep count, with the path's stencil and taps and with an
    anisotropic stencil and asymmetric taps; both timed at every level of
    the path, with the kernels' device time beside."""
    names = ("presmooth_residual_restrict", "prolong_correct_postsmooth_col")
    stats = {name: {"max_abs_err": 0.0} for name in names}
    check_leg2d_info(transfer)
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(0)
    for n, m in CHECK_2D:
        def normal(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                device=device)
        u, b, e = normal(n, m), normal(n, m), normal((n - 1) // 2,
                                                     (m - 1) // 2)
        for vals, r_taps, p_taps in ((VALS, R_TAPS, P_TAPS),
                                     (ANISO, R_TAPS_ASYM, P_TAPS_ASYM)):
            tag = f"{n}x{m} {'asym' if vals is ANISO else 'path'}"
            down, up = (0.0, 0.0), 0.0
            for sweeps in (1, 2, 3):
                ids = [1, 2, 3][:sweeps]
                us_k, rc_k = transfer.presmooth_residual_restrict(
                    u, b, omegas, ids, vals, r_taps)
                us_p, rc_p = transfer.presmooth_residual_restrict_plain(
                    u, b, omegas, ids, vals, r_taps)
                err_u = float((us_k - us_p).abs().max())
                err_rc = float((rc_k - rc_p).abs().max())
                check(err_u <= TOL_U and err_rc <= TOL_RC,
                      f"down-leg {tag} S={sweeps}: max|du| {err_u:.3e}, "
                      f"max|drc| {err_rc:.3e}")
                down = (max(down[0], err_u), max(down[1], err_rc))

                ids = [0, 1, 2, 3][:sweeps + 1]
                o_k = transfer.prolong_correct_postsmooth_col(
                    u, e, b, omegas, ids, vals, p_taps)
                o_p = transfer.prolong_correct_postsmooth_col_plain(
                    u, e, b, omegas, ids, vals, p_taps)
                err = float((o_k - o_p).abs().max())
                check(err <= TOL_U,
                      f"up-leg {tag} S={sweeps}: max|du| {err:.3e}")
                up = max(up, err)
            log(f"[kernels] down-leg {tag}, S=1..3: max|du| {down[0]:.3e} "
                f"(tol {TOL_U}), max|drc| {down[1]:.3e} (tol {TOL_RC})")
            log(f"[kernels] up-leg {tag}, S=1..3: max|du| {up:.3e} "
                f"(tol {TOL_U})")
            stats[names[0]]["max_abs_err"] = max(
                stats[names[0]]["max_abs_err"], *down)
            stats[names[1]]["max_abs_err"] = max(
                stats[names[1]]["max_abs_err"], up)
    # the path's levels with its sweeps: V(2,1) -> 2 pre, 1 post
    for n in LEVELS_2D:
        time_2d_legs(torch, transfer, device, (n, n),
                     stats if n == LEVELS_2D[0] else None)
    return stats


#: [kernels] bf16: the shapes where the bf16-storage legs are held
#: against their plain versions: every level of the path (the gated
#: levels of [deep-bf16] are 1023^2, 511^2 and 255^2) and a ragged shape
#: near the gate
CHECK_BF16 = [(n, n) for n in LEVELS_2D] + [(129, 131)]
#: the bf16 legs' slack against their plain versions, in bf16 ulps of
#: max|plain|: both compute in float32, in other orders, and round each
#: output once, so a value whose float32 results straddle a rounding
#: boundary lands one ulp apart (the CPU tests hold the plain version to
#: the float32 computation rounded once, tests/test_torch_refine.py)
TOL_BF16_ULPS = 2


def bf16_ulp(torch, x):
    """One bf16 ulp at the magnitude of ``x`` (> 0)."""
    return float(torch.finfo(torch.bfloat16).eps) * 2.0 ** np.floor(
        np.log2(x))


def phase_kernels_bf16(torch, transfer, device):
    """[kernels] bf16: each bf16-storage instantiation of rows 1-2
    (``transfer.leg_info(..., dtype=torch.bfloat16)``: tile, halo,
    threads, blocks per SM, registers, no spill) and each leg against its
    plain version on the card at CHECK_BF16 for 1..3 sweeps, within
    TOL_BF16_ULPS bf16 ulps of max|plain|; both timed at every level of
    the path, bytes counted at 2 a value."""
    names = ("presmooth_residual_restrict_bf16",
             "prolong_correct_postsmooth_col_bf16")
    stats = {name: {"max_abs_err": 0.0} for name in names}
    check_leg2d_info(transfer, "kernels", dtype=torch.bfloat16)
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(6)
    for n, m in CHECK_BF16:
        def normal(*shape):
            return torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32,
                                device=device).to(torch.bfloat16)
        u, b, e = normal(n, m), normal(n, m), normal((n - 1) // 2,
                                                     (m - 1) // 2)
        worst = {name: (0.0, 0.0) for name in names}
        for sweeps in (1, 2, 3):
            ids = [1, 2, 3][:sweeps]
            kern = transfer.presmooth_residual_restrict(
                u, b, omegas, ids, VALS, R_TAPS)
            plain = transfer.presmooth_residual_restrict_plain(
                u, b, omegas, ids, VALS, R_TAPS)
            ids = [0, 1, 2, 3][:sweeps + 1]
            kern_up = transfer.prolong_correct_postsmooth_col(
                u, e, b, omegas, ids, VALS, P_TAPS)
            plain_up = transfer.prolong_correct_postsmooth_col_plain(
                u, e, b, omegas, ids, VALS, P_TAPS)
            for name, ks, ps in ((names[0], kern, plain),
                                 (names[1], (kern_up,), (plain_up,))):
                for k, p in zip(ks, ps):
                    check(k.dtype == p.dtype == torch.bfloat16,
                          f"{name}: {k.dtype} / {p.dtype}")
                    err = float((k.float() - p.float()).abs().max())
                    scale = float(p.float().abs().max())
                    ulps = err / bf16_ulp(torch, scale)
                    check(ulps <= TOL_BF16_ULPS,
                          f"{name} {n}x{m} S={sweeps}: max|d| {err:.3e}, "
                          f"{ulps:.2f} bf16 ulps of max|plain| {scale:.3e}")
                    worst[name] = max(worst[name], (ulps, err))
                    stats[name]["max_abs_err"] = max(
                        stats[name]["max_abs_err"], err)
        for name, (ulps, err) in worst.items():
            log(f"[kernels] bf16 {name} {n}x{m}, S=1..3: max|d| {err:.3e}, "
                f"{ulps:.2f} bf16 ulps of max|plain| (tol {TOL_BF16_ULPS} "
                "ulps)")
    for n in LEVELS_2D:
        time_2d_legs(torch, transfer, device, (n, n),
                     stats if n == LEVELS_2D[0] else None,
                     dtype=torch.bfloat16)
    return stats


#: the row-only and fused kernels: (form, the sweep counts checked), the
#: form named as transfer.leg_info names it; a fused pass's count is a
#: (post, pre) pair
PASS_FORMS = ("pass", "rowpass")
LOOP_KERNELS = {
    "presmooth_residual_rowrestrict": ("rowdown", (1, 2, 3)),
    "prolong_correct_postsmooth": ("rowup", (1, 2, 3)),
    "upleg_downleg_col": ("pass", [(post, pre) for post in (1, 2, 3)
                                   for pre in (1, 2, 3)]),
    "upleg_downleg_fused": ("rowpass", [(post, pre) for post in (1, 2, 3)
                                        for pre in (1, 2, 3)])}


def loop_work(name, shape, sweeps):
    """(bytes, float32 operations) of a row-only leg or a fused pass on a
    fine grid of ``shape``: u and b read and u written once, and
    the coarse operands once each (e read and rc written by
    ``upleg_downleg_col``; the (n-1)/2 x m row-only arrays otherwise);
    ``sweeps`` sweeps of 10 operations a point, and the leg work of
    LEG_FLOPS (a row-only transfer: its row half, 5/2 a point to restrict,
    2 to prolong)."""
    n, m = shape
    fine, half, coarse = n * m, (n - 1) // 2 * m, (n - 1) // 2 * ((m - 1) // 2)
    work = {"upleg_downleg_col": (2 * coarse, LEG_FLOPS[("down", 2)]
                                  + LEG_FLOPS[("up", 2)]),
            "presmooth_residual_rowrestrict": (half, 6 + 2.5),
            "prolong_correct_postsmooth": (half, 2 + 2),
            "upleg_downleg_fused": (2 * half, 6 + 2.5 + 2 + 2)}
    moved, flops = work[name]
    return 4 * (3 * fine + moved), fine * (sweeps * 10 + flops)


def loop_calls(transfer, omegas, name, u, b, e, ch, sweeps, vals, r_taps,
               p_taps):
    """(kernel, plain) thunks of one row-only leg or fused pass for
    ``sweeps`` (a fused pass's: a (post, pre) pair)."""
    form = LOOP_KERNELS[name][0]
    if form == "rowdown":
        args = (u, b, omegas, [1, 2, 3][:sweeps], vals, r_taps[0])
    elif form == "rowup":
        args = (u, ch, b, omegas, [0, 1, 2, 3][:sweeps + 1], vals,
                p_taps[0])
    else:
        ids = list(range(1 + sum(sweeps)))
        args = ((u, e, b, omegas, ids, vals, p_taps, r_taps)
                if form == "pass" else
                (u, ch, b, omegas, ids, vals, p_taps[0], r_taps[0]))
    kern = getattr(transfer, name)
    plain = getattr(transfer, name + "_plain")
    return lambda: kern(*args), lambda: plain(*args)


#: where time_loop_kernels times each kernel: (fine size, sweeps); the
#: row-only legs with the main path's sweeps (V(2,1): 2 pre, 1 post) at
#: every level of the path, the fused passes with the path's (1 post + 2
#: pre) and the longest (3 + 3) at 4095^2 and at the finest level of a
#: 2047^2 hierarchy
LOOP_TIMINGS = {"rowdown": [(n, 2) for n in LEVELS_2D],
                "rowup": [(n, 1) for n in LEVELS_2D],
                **{form: [(n, pair) for n in (4095, 2047)
                          for pair in ((1, 2), (3, 3))]
                   for form in PASS_FORMS}}


def time_loop_kernels(torch, transfer, device, stats=None):
    """The row-only legs and the fused passes at LOOP_TIMINGS: kernel and
    plain in turns (time_pair), the numbers of 4095^2 with the main
    path's sweeps going to ``stats`` when it is given, the kernel's device
    time alone (time_ms_queued) logged beside.  Uses only the wrappers'
    public signatures, so it times an older tree's package as well."""
    rng = np.random.default_rng(8)
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3, 0.7, 1.05, 0.95],
                          dtype=torch.float32, device=device)
    for n in sorted({size for timings in LOOP_TIMINGS.values()
                     for size, _ in timings}, reverse=True):
        m = n
        u, b, e, ch = (torch.tensor(rng.standard_normal(s),
                                    dtype=torch.float32, device=device)
                       for s in ((n, m), (n, m),
                                 ((n - 1) // 2, (m - 1) // 2),
                                 ((n - 1) // 2, m)))
        for name, (form, _) in LOOP_KERNELS.items():
            for sweeps in [s for size, s in LOOP_TIMINGS[form] if size == n]:
                kern, plain = loop_calls(transfer, omegas, name, u, b, e, ch,
                                         sweeps, VALS, R_TAPS, P_TAPS)
                total = sum(sweeps) if form in PASS_FORMS else sweeps
                nbytes, flops = loop_work(name, (n, m), total)
                bound, by = bytes_bound(nbytes, flops)
                k, p, turns = time_pair(torch, kern, plain)
                log(f"[kernels-loop] {name} {n}^2 S={total} ({nbytes} bytes,"
                    f" {flops:.4e} float32 operations): kernel "
                    f"{turns[1]:.4f}/{turns[2]:.4f} ms, plain "
                    f"{turns[0]:.4f}/{turns[3]:.4f} ms, bound {bound:.4f} ms "
                    f"({by}); kernel queued "
                    f"{time_ms_queued(torch, kern):.4f} ms")
                path = 3 if form in PASS_FORMS else {"rowdown": 2,
                                                      "rowup": 1}[form]
                if stats is not None and (n, total) == (4095, path):
                    stats[name].update(ms=k, plain_ms=p, bound_ms=bound,
                                       bound_by=by)


#: where phase_kernels_loop holds the kernels against their plain
#: versions: the path's 4095^2, a ragged level, and 1023^2, where the
#: window rule picks the 32 x 64 class for passes of up to 4 sweeps
#: (row-only: 3); the fused passes run only at 4095^2 on [main-fused]
CHECK_LOOP = [(4095, 4095), (1023, 2047), (1023, 1023)]
#: the row-only legs run at every level of [main-fused] (b) and (c), so
#: they are held at the path's other levels as well
CHECK_ROW_LEGS = CHECK_LOOP + [(n, n) for n in LEVELS_2D
                               if (n, n) not in CHECK_LOOP]


def phase_kernels_loop(torch, transfer, device):
    """The row-only legs and the fused passes against their plain
    versions, after each pass and row-only leg instantiation's info is
    checked: the passes at CHECK_LOOP, the row-only legs at CHECK_ROW_LEGS;
    both timed at LOOP_TIMINGS."""
    stats = {name: {"max_abs_err": 0.0} for name in LOOP_KERNELS}
    check_leg2d_info(transfer, "kernels-loop",
                     (("pass", range(1, 7)), ("rowpass", range(1, 7)),
                      ("rowdown", (1, 2, 3)), ("rowup", (1, 2, 3))))
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3, 0.7, 1.05, 0.95],
                          dtype=torch.float32, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(7)
    for n, m in CHECK_ROW_LEGS:
        def normal(*shape):
            return torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=device)
        u, b = normal(n, m), normal(n, m)
        e, ch = normal((n - 1) // 2, (m - 1) // 2), normal((n - 1) // 2, m)
        kernels = {name: form_counts for name, form_counts
                   in LOOP_KERNELS.items()
                   if (n, m) in CHECK_LOOP or form_counts[0] not in PASS_FORMS}
        for leg, counts in (("pass", range(2, 7)), ("rowpass", range(2, 7)),
                            ("rowdown", (1, 2, 3)), ("rowup", (1, 2, 3))):
            if (n, m) not in CHECK_LOOP and leg in PASS_FORMS:
                continue
            log(f"[kernels-loop] {n}x{m}: the {leg}'s window class for S = "
                f"{counts[0]}..{counts[-1]}: " + ", ".join(
                    str(transfer.leg_window(leg, s, n, m, sms))
                    for s in counts))
        for vals, r_taps, p_taps in ((VALS, R_TAPS, P_TAPS),
                                     (ANISO, R_TAPS_ASYM, P_TAPS_ASYM)):
            tag = f"{n}x{m} {'asym' if vals is ANISO else 'path'}"
            for name, (form, counts) in kernels.items():
                worst = (0.0, 0.0)
                for sweeps in counts:
                    kern, plain = loop_calls(transfer, omegas, name, u, b, e,
                                             ch, sweeps, vals, r_taps, p_taps)
                    k, p = kern(), plain()
                    torch.cuda.synchronize()
                    if form == "rowup":
                        k, p = (k,), (p,)
                    err_u = float((k[0] - p[0]).abs().max())
                    err_r = float((k[1] - p[1]).abs().max()) \
                        if len(k) > 1 else 0.0
                    check(err_u <= TOL_U and err_r <= TOL_RC,
                          f"{name} {tag} sweeps {sweeps}: max|du| "
                          f"{err_u:.3e}, max|dr| {err_r:.3e}")
                    worst = (max(worst[0], err_u), max(worst[1], err_r))
                log(f"[kernels-loop] {name} {tag}, sweeps {counts[0]}.."
                    f"{counts[-1]}: max|du| {worst[0]:.3e} (tol {TOL_U}), "
                    f"max|dr| {worst[1]:.3e} (tol {TOL_RC})")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 *worst)
    time_loop_kernels(torch, transfer, device, stats)
    return stats


def time_3d_legs(torch, wavefront3d, device, shape, stats=None):
    """Both 3D legs of the V(2,1) (2 sweeps down, 1 up) at ``shape``:
    kernel and plain in turns as the other kernels are timed (time_pair),
    the numbers going to ``stats`` when it is given; the kernel's device
    time alone (time_ms_queued, without the wrapper's host work that
    time_pair counts) is logged beside them.  Uses only the wrappers'
    public signatures, so it times an older tree's package as well."""
    rng = np.random.default_rng(2)
    cshape = tuple((n - 1) // 2 for n in shape)
    u, b, e = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device=device) for s in (shape, shape, cshape))
    omegas = torch.tensor([0.9, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    timed = {
        "downleg_wavefront_3d": (
            lambda: wavefront3d.downleg_wavefront_3d(
                u, b, omegas, [1, 2], VALS7, R_TAPS3),
            lambda: wavefront3d.downleg_wavefront_3d_plain(
                u, b, omegas, [1, 2], VALS7, R_TAPS3),
            leg_bound(shape, 2, "down")),
        "upleg_wavefront_3d": (
            lambda: wavefront3d.upleg_wavefront_3d(
                u, e, b, omegas, [0, 1], VALS7, P_TAPS3),
            lambda: wavefront3d.upleg_wavefront_3d_plain(
                u, e, b, omegas, [0, 1], VALS7, P_TAPS3),
            leg_bound(shape, 1, "up")),
    }
    tag = "x".join(map(str, shape))
    for name, (kern, plain, (bound, by)) in timed.items():
        k, p, turns = time_pair(torch, kern, plain)
        log(f"[kernels3d] {name} {tag}: kernel {turns[1]:.4f}/"
            f"{turns[2]:.4f} ms, plain {turns[0]:.4f}/{turns[3]:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); kernel queued "
            f"{time_ms_queued(torch, kern):.4f} ms")
        if stats is not None:
            stats[name].update(ms=k, plain_ms=p, bound_ms=bound,
                               bound_by=by)


def check_pipeline_info(tag, what, i, tile, halo, warmup, min_chunk,
                        threads, blocks_per_sm):
    """A 3D plane-pipeline kernel's schedule constants, occupancy,
    registers, local memory (spills) and shared memory, from the card
    (``i``, its info entry's values); the schedule, the threads and the
    blocks per SM it was designed for must be the wrapper module's, and
    nothing may spill."""
    log(f"[{tag}] {what}: tile {i['tile']}, halo "
        f"{i['halo_before']}/{i['halo_after']}, warm-up {i['warmup']}, "
        f"lag {i['lag']}, chunks of >= {i['min_chunk']} planes, "
        f"{i['threads']} threads, {i['blocks_per_sm']} blocks/SM, "
        f"{i['registers']} registers, {i['local_bytes']} B local, "
        f"{i['smem_bytes']} B shared")
    from evostencils_tpu_torch.ops.kernels.wavefront3d import LAG
    want = {"tile": tile, "halo_before": halo[0], "halo_after": halo[1],
            "warmup": warmup, "lag": LAG, "min_chunk": min_chunk,
            "threads": threads, "blocks_per_sm": blocks_per_sm,
            "local_bytes": 0}
    check(all(i[k] == v for k, v in want.items()),
          f"{what} info {i} against the wrapper's {want}")


def check_leg3d_info(wavefront3d):
    """Each 3D leg kernel's info (check_pipeline_info)."""
    for leg in ("down", "up"):
        check_pipeline_info(
            "kernels3d", f"{leg}-leg", wavefront3d.leg_info(leg),
            wavefront3d.TILE, wavefront3d.HALO[leg], wavefront3d.WARMUP[leg],
            wavefront3d.MIN_CHUNK, wavefront3d.THREADS[leg],
            wavefront3d.BLOCKS_PER_SM[leg])


def phase_kernels_3d(torch, wavefront3d, device):
    """Each 3D kernel against its plain version at the 3D path's levels
    and a ragged shape; both timed at every level of the path, with the
    kernels' device time beside."""
    names = ("downleg_wavefront_3d", "upleg_wavefront_3d")
    stats = {name: {"max_abs_err": 0.0} for name in names}
    check_leg3d_info(wavefront3d)
    # ids [1, 2] -> (1.15, 0.8) for the down-leg's two sweeps; [0, 1] ->
    # (0.9, 1.15) for the up-leg's correction and sweep
    omegas = torch.tensor([0.9, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(1)
    for shape in [(255, 255, 255), (65, 127, 255), (127, 127, 127),
                  (63, 63, 63)]:
        def normal(*s):
            return torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=device)
        cshape = tuple((n - 1) // 2 for n in shape)
        u, b, e = normal(*shape), normal(*shape), normal(*cshape)
        tag = "x".join(map(str, shape))
        us_k, rc_k = wavefront3d.downleg_wavefront_3d(u, b, omegas, [1, 2],
                                                      VALS7, R_TAPS3)
        us_p, rc_p = wavefront3d.downleg_wavefront_3d_plain(
            u, b, omegas, [1, 2], VALS7, R_TAPS3)
        torch.cuda.synchronize()
        err_u = float((us_k - us_p).abs().max())
        err_rc = float((rc_k - rc_p).abs().max())
        log(f"[kernels3d] down-leg {tag}: max|du| {err_u:.3e} (tol "
            f"{TOL_U3}), max|drc| {err_rc:.3e} (tol {TOL_RC3})")
        check(err_u <= TOL_U3 and err_rc <= TOL_RC3, f"3D down-leg {tag}")
        o_k = wavefront3d.upleg_wavefront_3d(u, e, b, omegas, [0, 1], VALS7,
                                             P_TAPS3)
        o_p = wavefront3d.upleg_wavefront_3d_plain(u, e, b, omegas, [0, 1],
                                                   VALS7, P_TAPS3)
        err = float((o_k - o_p).abs().max())
        log(f"[kernels3d] up-leg {tag}: max|du| {err:.3e} (tol {TOL_U3})")
        check(err <= TOL_U3, f"3D up-leg {tag}")
        for name, dev in zip(names, (max(err_u, err_rc), err)):
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], dev)
    # the path's levels: kernel and plain in turns, the device time beside
    for n in (255, 127, 63):
        time_3d_legs(torch, wavefront3d, device, (n, n, n),
                     stats if n == 255 else None)
    return stats


def sweep_bound(shape):
    """A sweep reads u and b and writes u once (float32) and updates each
    point once, 2d + 6 operations in d dimensions as a leg's sweep
    (leg_bound)."""
    points = int(np.prod(shape))
    return bytes_bound(3 * 4 * points, (2 * len(shape) + 6) * points)


def transfer_bound(shape):
    """A standalone transfer reads two fine arrays (u and b, or u) and
    writes one fine or coarse array, and moves the coarse one once: the
    residual + restriction reads u, b and writes rc; the prolongation +
    correction reads u, e and writes u, which both come to
    2 * fine + coarse float32 values.  About 10 operations a fine point
    (the residual, or the two-axis interpolation and the update) and 20
    a coarse point (the 3 x 3 restriction)."""
    fine = int(np.prod(shape))
    coarse = int(np.prod([(n - 1) // 2 for n in shape]))
    return bytes_bound(4 * (2 * fine + coarse), 10 * fine + 20 * coarse)


def transfer3d_bound(shape, leg):
    """A 3D transfer reads two fine arrays (u and b, or u) and writes one,
    and moves the coarse array once: 2 * fine + coarse float32 values; it
    does the residual and restriction (``leg`` "down") or the
    prolongation and correction ("up") work of LEG_FLOPS."""
    fine = int(np.prod(shape))
    coarse = int(np.prod([(n - 1) // 2 for n in shape]))
    return bytes_bound(4 * (2 * fine + coarse), fine * LEG_FLOPS[(leg, 3)])


def deviation(torch, k, p, rtol, atol):
    """(max |k - p|, largest excess over atol + rtol * |p|)."""
    torch.cuda.synchronize()
    d = (k - p).abs()
    return float(d.max()), float((d - (atol + rtol * p.abs())).max())


def time_standalone(torch, stats, name, tag, shape, kern, plain, bound,
                    keep=(4095, 4095)):
    """Time kernel and plain in turns, the kernel's device time alone
    (time_ms_queued) and the bound's share of it logged beside; keep the
    numbers of shape ``keep`` for the kernels line when ``stats`` is
    given."""
    k, p, turns = time_pair(torch, kern, plain)
    ms, by = bound
    queued = time_ms_queued(torch, kern)
    log(f"[{tag}] {name} {'x'.join(map(str, shape))}: kernel "
        f"{turns[1]:.4f}/{turns[2]:.4f} ms, plain {turns[0]:.4f}/"
        f"{turns[3]:.4f} ms, bound {ms:.4f} ms ({by}); kernel queued "
        f"{queued:.4f} ms ({100 * ms / queued:.1f}% of the bound)")
    if stats is not None and shape == keep:
        stats[name].update(ms=k, plain_ms=p, bound_ms=ms, bound_by=by)


#: the square shapes where the 2D standalone sweeps and transfers are held
#: and timed: 4095^2 for the kernels line, and the levels of the
#: [evaluator] hierarchy (1023^2 .. 255^2), where they run
STANDALONE_SHAPES = [(4095, 4095), (1023, 1023), (511, 511), (255, 255)]


def check_rbgs_sweep_info(rbgs):
    """The single-pass sweep kernel of each mode (``rbgs.sweep_info``):
    its strip, block, threads, blocks per SM, registers, local memory
    (spills) and shared memory, from the card.  Strip and block must be
    the wrapper module's; at least SWEEP_BLOCKS_PER_SM blocks must be
    resident; nothing may spill.  Then the red-black kernel's
    (``rbgs.fused_sweep_info``): tile, halo and threads must be the
    wrapper module's window, at least FUSED_BLOCKS_PER_SM blocks
    resident, nothing spilled."""
    for one_colour in (False, True):
        i = rbgs.sweep_info(one_colour)
        what = "parity 0/1" if one_colour else "parity -1"
        log(f"[kernels-rbgs] sweep {what}: strip {i['strip']} rows, block "
            f"{i['block_cols']}x{i['block_strips']} ({i['threads']} "
            f"threads), {i['blocks_per_sm']} blocks/SM, {i['registers']} "
            f"registers, {i['local_bytes']} B local, {i['smem_bytes']} B "
            "shared")
        want = {"strip": rbgs.SWEEP_STRIP, "block_cols": rbgs.SWEEP_BLOCK[0],
                "block_strips": rbgs.SWEEP_BLOCK[1], "local_bytes": 0}
        check(all(i[k] == v for k, v in want.items())
              and i["blocks_per_sm"] >= rbgs.SWEEP_BLOCKS_PER_SM,
              f"sweep {what} info {i} against the wrapper's {want}, "
              f"{rbgs.SWEEP_BLOCKS_PER_SM} blocks/SM")
    i = rbgs.fused_sweep_info()
    log(f"[kernels-rbgs] red-black sweep: tile {i['tile_rows']}x"
        f"{i['tile_cols']}, halo {i['halo']}, {i['threads']} threads, "
        f"{i['blocks_per_sm']} blocks/SM, {i['registers']} registers, "
        f"{i['local_bytes']} B local, {i['smem_bytes']} B shared")
    tile = rbgs.fused_tile()
    want = {"tile_rows": tile[0], "tile_cols": tile[1],
            "halo": rbgs.FUSED_HALO, "threads": rbgs.FUSED_THREADS,
            "local_bytes": 0}
    check(all(i[k] == v for k, v in want.items())
          and i["blocks_per_sm"] >= rbgs.FUSED_BLOCKS_PER_SM,
          f"red-black sweep info {i} against the wrapper's {want}, "
          f"{rbgs.FUSED_BLOCKS_PER_SM} blocks/SM")


def phase_kernels_rbgs(torch, rbgs, device):
    """The standalone sweep kernels against their plain versions."""
    check_rbgs_sweep_info(rbgs)
    stats = {name: {"max_abs_err": 0.0}
             for name in ("fused_rbgs_sweep", "jacobi_sweep")}
    omegas = torch.tensor([0.6, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(2)
    for shape in STANDALONE_SHAPES + [(300, 200)]:
        def normal():
            return torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=device)
        u, b = normal(), normal()
        modes = [("fused", "fused_rbgs_sweep",
                  lambda: rbgs.fused_rbgs_sweep(u, b, omegas, 1, ANISO),
                  lambda: rbgs.fused_rbgs_sweep_plain(u, b, omegas, 1,
                                                      ANISO))]
        modes += [(f"parity {par}", "jacobi_sweep",
                   lambda par=par: rbgs.sweep(u, b, omegas, 1, ANISO, par),
                   lambda par=par: rbgs.sweep_plain(u, b, omegas, 1, ANISO,
                                                    par))
                  for par in (-1, 0, 1)]
        for mode, name, kern, plain in modes:
            err, excess = deviation(torch, kern(), plain(), TOL_SWEEP,
                                    TOL_SWEEP)
            log(f"[kernels-rbgs] {mode} {shape[0]}x{shape[1]}: max|du| "
                f"{err:.3e} (tol {TOL_SWEEP} + {TOL_SWEEP}|u|)")
            check(excess <= 0, f"sweep {mode} {shape}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if shape[0] != shape[1]:
            continue
        # the path's Laplacian, timed in turns at the path's levels
        time_standalone(
            torch, stats, "fused_rbgs_sweep", "kernels-rbgs", shape,
            lambda: rbgs.fused_rbgs_sweep(u, b, omegas, 1, VALS),
            lambda: rbgs.fused_rbgs_sweep_plain(u, b, omegas, 1, VALS),
            sweep_bound(shape))
        time_standalone(
            torch, stats, "jacobi_sweep", "kernels-rbgs", shape,
            lambda: rbgs.jacobi_sweep(u, b, omegas, 2, VALS),
            lambda: rbgs.jacobi_sweep_plain(u, b, omegas, 2, VALS),
            sweep_bound(shape))
        # one pass of one colour (half of rbgs_sweep), against the same
        # bound: it reads u and b and writes u as the Jacobi pass does
        time_standalone(
            torch, None, "rbgs half-sweep (parity 0)", "kernels-rbgs", shape,
            lambda: rbgs.sweep(u, b, omegas, 2, VALS, 0),
            lambda: rbgs.sweep_plain(u, b, omegas, 2, VALS, 0),
            sweep_bound(shape))
    return stats


def phase_kernels_rr(torch, transfer, device):
    """The standalone transfer kernels against their plain versions; their
    instantiations (the down-leg and the up-leg of no sweep)."""
    stats = {name: {"max_abs_err": 0.0}
             for name in ("residual_restrict", "prolong_correct")}
    check_leg2d_info(transfer, "kernels-rr", (("down", (0,)), ("up", (0,))))
    omegas = torch.tensor([0.6, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(3)
    for shape in STANDALONE_SHAPES + [(257, 255)]:
        def normal(*s):
            return torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=device)
        n, m = shape
        u, b, e = normal(n, m), normal(n, m), normal((n - 1) // 2,
                                                     (m - 1) // 2)
        for vals, r_taps, p_taps in ((VALS, R_TAPS, P_TAPS),
                                     (ANISO, R_TAPS_ASYM, P_TAPS_ASYM)):
            tag = f"{n}x{m} {'asym' if vals is ANISO else 'path'}"
            err, excess = deviation(
                torch, transfer.residual_restrict(u, b, vals, r_taps),
                transfer.residual_restrict_plain(u, b, vals, r_taps), 0.0,
                TOL_TRANSFER)
            log(f"[kernels-rr] residual_restrict {tag}: max|drc| {err:.3e} "
                f"(tol {TOL_TRANSFER})")
            check(excess <= 0, f"residual_restrict {tag}")
            stats["residual_restrict"]["max_abs_err"] = max(
                stats["residual_restrict"]["max_abs_err"], err)
            err, excess = deviation(
                torch, transfer.prolong_correct(u, e, omegas, 2, p_taps),
                transfer.prolong_correct_plain(u, e, omegas, 2, p_taps), 0.0,
                TOL_TRANSFER)
            log(f"[kernels-rr] prolong_correct {tag}: max|du| {err:.3e} "
                f"(tol {TOL_TRANSFER})")
            check(excess <= 0, f"prolong_correct {tag}")
            stats["prolong_correct"]["max_abs_err"] = max(
                stats["prolong_correct"]["max_abs_err"], err)
    for shape in STANDALONE_SHAPES:
        time_2d_transfers(torch, transfer, device, shape, stats)
    return stats


def time_2d_transfers(torch, transfer, device, shape, stats=None):
    """Both 2D standalone transfers at ``shape`` with the path's Laplacian
    and taps: kernel and plain in turns, the device time alone and its
    share of the bound beside (time_standalone).  Uses only the wrappers'
    public signatures, so it times an older tree's package as well."""
    rng = np.random.default_rng(3)
    n, m = shape
    u, b, e = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device=device)
               for s in (shape, shape, ((n - 1) // 2, (m - 1) // 2)))
    omegas = torch.tensor([0.6, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    time_standalone(
        torch, stats, "residual_restrict", "kernels-rr", shape,
        lambda: transfer.residual_restrict(u, b, VALS, R_TAPS),
        lambda: transfer.residual_restrict_plain(u, b, VALS, R_TAPS),
        transfer_bound(shape))
    time_standalone(
        torch, stats, "prolong_correct", "kernels-rr", shape,
        lambda: transfer.prolong_correct(u, e, omegas, 1, P_TAPS),
        lambda: transfer.prolong_correct_plain(u, e, omegas, 1, P_TAPS),
        transfer_bound(shape))


#: the 3D path's levels, where the 3D standalone kernels are timed
LEVELS_3D = (255, 127, 63)


def time_3d_sweeps(torch, rbgs3d, leg3d, device, n, stats=None):
    """Both 3D standalone sweeps at n^3 with the path's Laplacian, through
    the names whose gate admits n^3 (leg3d at 255^3, rbgs3d below): kernel
    and plain in turns, the device time alone and its share of the bound
    beside (time_standalone).  Uses only the wrappers' public signatures,
    so it times an older tree's package as well."""
    shape = (n,) * 3
    rng = np.random.default_rng(6)
    u, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=device) for _ in range(2))
    omegas = torch.tensor([0.6, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    mod = leg3d if n >= 255 else rbgs3d
    names = (("fused_rbgs_sweep_3d2", "jacobi_sweep_3d2") if n >= 255 else
             ("fused_rbgs_sweep_3d", "jacobi_sweep_3d"))
    for name in names:
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        time_standalone(
            torch, stats, name, "kernels-sweep3d", shape,
            lambda: kern(u, b, omegas, 1, VALS7),
            lambda: plain(u, b, omegas, 1, VALS7), sweep_bound(shape),
            keep=(255,) * 3 if mod is leg3d else (127,) * 3)


def phase_kernels_sweep3d(torch, rbgs3d, leg3d, device):
    """The 3D standalone sweeps against their plain versions: through the
    leg3d names on the shapes the leg3d gate admits, through the rbgs3d
    names on the shapes the rbgs3d gate admits; the red-black kernel's
    info; both timed at the path's levels."""
    names = {"rbgs3d": ("fused_rbgs_sweep_3d", "jacobi_sweep_3d"),
             "leg3d": ("fused_rbgs_sweep_3d2", "jacobi_sweep_3d2")}
    stats = {name: {"max_abs_err": 0.0} for pair in names.values()
             for name in pair}
    check_pipeline_info(
        "kernels-sweep3d", "red-black sweep", rbgs3d.sweep_info(),
        rbgs3d.RB_TILE, rbgs3d.RB_HALO, rbgs3d.RB_WARMUP,
        rbgs3d.RB_MIN_CHUNK, rbgs3d.RB_THREADS, rbgs3d.RB_BLOCKS_PER_SM)
    omegas = torch.tensor([0.6, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(4)
    cases = [("leg3d", (255, 255, 255)), ("leg3d", (65, 127, 255)),
             ("leg3d", (17, 33, 63)), ("rbgs3d", (127, 127, 127)),
             ("rbgs3d", (63, 63, 63)), ("rbgs3d", (12, 40, 200))]
    for module, shape in cases:
        mod = rbgs3d if module == "rbgs3d" else leg3d
        u, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                             device=device) for _ in range(2))
        for name in names[module]:
            kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
            err, excess = deviation(
                torch, kern(u, b, omegas, 1, ANISO7),
                plain(u, b, omegas, 1, ANISO7), TOL_SWEEP, TOL_SWEEP)
            log(f"[kernels-sweep3d] {name} {'x'.join(map(str, shape))}: "
                f"max|du| {err:.3e} (tol {TOL_SWEEP} + {TOL_SWEEP}|u|)")
            check(excess <= 0, f"{name} {shape}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    # the path's Laplacian, timed in turns at the path's levels
    for n in LEVELS_3D:
        time_3d_sweeps(torch, rbgs3d, leg3d, device, n, stats)
    return stats


def time_3d_transfers(torch, leg3d, device, n, stats=None):
    """Both 3D standalone transfers at n^3 with the path's Laplacian and
    taps, timed as time_3d_sweeps."""
    shape = (n,) * 3
    rng = np.random.default_rng(7)
    u, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=device) for _ in range(2))
    e = torch.tensor(rng.standard_normal(((n - 1) // 2,) * 3),
                     dtype=torch.float32, device=device)
    omegas = torch.tensor([0.6, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    time_standalone(
        torch, stats, "residual_restrict_3d", "kernels-rr3d", shape,
        lambda: leg3d.residual_restrict_3d(u, b, VALS7, R_TAPS3),
        lambda: leg3d.residual_restrict_3d_plain(u, b, VALS7, R_TAPS3),
        transfer3d_bound(shape, "down"), keep=(255,) * 3)
    time_standalone(
        torch, stats, "prolong_correct_3d", "kernels-rr3d", shape,
        lambda: leg3d.prolong_correct_3d(u, e, omegas, 1, P_TAPS3),
        lambda: leg3d.prolong_correct_3d_plain(u, e, omegas, 1, P_TAPS3),
        transfer3d_bound(shape, "up"), keep=(255,) * 3)


def phase_kernels_rr3d(torch, leg3d, device):
    """The 3D standalone transfers against their plain versions; both
    kernels' info; both timed at the path's levels."""
    stats = {name: {"max_abs_err": 0.0}
             for name in ("residual_restrict_3d", "prolong_correct_3d")}
    check_pipeline_info(
        "kernels-rr3d", "residual restriction", leg3d.restrict_info(),
        leg3d.RR_TILE, leg3d.RR_HALO, leg3d.RR_WARMUP, leg3d.RR_MIN_CHUNK,
        leg3d.RR_THREADS, leg3d.RR_BLOCKS_PER_SM)
    check_pipeline_info(
        "kernels-rr3d", "prolongation-correction", leg3d.prolong_info(),
        leg3d.PC_TILE, leg3d.PC_HALO, leg3d.PC_WARMUP, leg3d.PC_MIN_CHUNK,
        leg3d.PC_THREADS, leg3d.PC_BLOCKS_PER_SM)
    omegas = torch.tensor([0.6, 1.15, 0.8], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(5)
    for shape in [(255, 255, 255), (127, 127, 127), (63, 63, 63),
                  (65, 127, 255)]:
        def normal(*s):
            return torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                device=device)
        cshape = tuple((n - 1) // 2 for n in shape)
        u, b, e = normal(*shape), normal(*shape), normal(*cshape)
        tag = "x".join(map(str, shape))
        err, excess = deviation(
            torch, leg3d.residual_restrict_3d(u, b, ANISO7, R_TAPS3_ASYM),
            leg3d.residual_restrict_3d_plain(u, b, ANISO7, R_TAPS3_ASYM),
            0.0, TOL_TRANSFER)
        log(f"[kernels-rr3d] residual_restrict_3d {tag}: max|drc| "
            f"{err:.3e} (tol {TOL_TRANSFER})")
        check(excess <= 0, f"residual_restrict_3d {tag}")
        stats["residual_restrict_3d"]["max_abs_err"] = max(
            stats["residual_restrict_3d"]["max_abs_err"], err)
        err, excess = deviation(
            torch, leg3d.prolong_correct_3d(u, e, omegas, 2, P_TAPS3_ASYM),
            leg3d.prolong_correct_3d_plain(u, e, omegas, 2, P_TAPS3_ASYM),
            0.0, TOL_TRANSFER)
        log(f"[kernels-rr3d] prolong_correct_3d {tag}: max|du| {err:.3e} "
            f"(tol {TOL_TRANSFER})")
        check(excess <= 0, f"prolong_correct_3d {tag}")
        stats["prolong_correct_3d"]["max_abs_err"] = max(
            stats["prolong_correct_3d"]["max_abs_err"], err)
    for n in LEVELS_3D:
        time_3d_transfers(torch, leg3d, device, n, stats)
    return stats


#: float32 operations per point of a variable-coefficient sweep: A u (5
#: products, 4 sums), b - A u, the reciprocal or quotient of the center,
#: its product with omega, the update's product and sum
VAR_SWEEP_FLOPS = 14


def var_sweep_bound(shape):
    """A variable-coefficient sweep reads u, b and the five coefficient
    planes and writes u once (float32)."""
    points = int(np.prod(shape))
    return bytes_bound(8 * 4 * points, VAR_SWEEP_FLOPS * points)


def var_leg_bound(shape, sweeps, leg):
    """A variable-coefficient leg moves what its sweeps move (u, b, five
    coefficient planes, u out) and the coarse array once; it does
    ``sweeps`` sweeps and the work of LEG_FLOPS."""
    fine = int(np.prod(shape))
    coarse = int(np.prod([(n - 1) // 2 for n in shape]))
    return bytes_bound(4 * (8 * fine + coarse),
                       fine * (sweeps * VAR_SWEEP_FLOPS + LEG_FLOPS[(leg, 2)]))


def var_problem_stack(torch, n, device):
    """The finest coefficient stack of poisson_2d_variable at n^2."""
    from evostencils_tpu_torch.ops.kernels import rbgs_var
    from evostencils_tpu_torch.problems.poisson import poisson_2d_variable
    level = (n + 1).bit_length() - 1
    op = poisson_2d_variable(max_level=level, min_level=level - 1) \
        .level_contexts[0].operator.entries[0][0]
    sf = op.stencil_generator.generate_stencil_field(op.grid)
    return rbgs_var.five_point_stack(sf, device=device, dtype=torch.float32)


def aniso_stack(torch, shape, rng, device):
    """A diagonally dominant random stack whose four neighbour planes
    differ in mean, so that a swapped plane or axis shows."""
    planes = [6.0 + rng.uniform(0.0, 1.0, shape)]
    planes += [mean + rng.uniform(-0.2, 0.2, shape)
               for mean in ANISO[1:]]
    return torch.tensor(np.stack(planes), dtype=torch.float32, device=device)


#: the [kernels-var] shapes and stacks: the main path's levels with the
#: problem's own stack, ragged shapes with an anisotropic random one (the
#: legs take the odd ones; 129x131 lies at the legs' gate)
VAR_CASES = [((2047, 2047), "problem"), ((1023, 1023), "problem"),
             ((511, 511), "problem"), ((255, 255), "problem"),
             ((1025, 771), "aniso"), ((129, 131), "aniso"),
             ((300, 200), "aniso")]
#: the levels of the var and complex paths that their gates admit, where
#: time_var_legs and time_cx_sweeps time the paths' kernels
LEVELS_2047 = (2047, 1023, 511, 255)


def time_var_legs(torch, rbgs_var, device, shape, stats=None):
    """Both legs of the V(2,1) (2 sweeps down, 1 up) with the problem's own
    stack at ``shape``, red-black and Jacobi: kernel and plain in turns as
    the other kernels are timed (time_pair), the red-black numbers going
    to ``stats`` when it is given; the kernel's device time alone
    (time_ms_queued, without the wrapper's host work that time_pair
    counts) is logged beside them.  Uses only the wrappers' public
    signatures, so it times an older tree's package as well."""
    rng = np.random.default_rng(12)
    n, m = shape
    u, b, e = (torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device=device)
               for s in (shape, shape, ((n - 1) // 2, (m - 1) // 2)))
    c = var_problem_stack(torch, n, device)
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    for red_black in (True, False):
        mode = "RB" if red_black else "Jacobi"
        timed = {
            VAR_LEGS[0]: (
                lambda: rbgs_var.presmooth_residual_restrict_var(
                    u, b, omegas, [1, 2], c, R_TAPS, red_black=red_black),
                lambda: rbgs_var.presmooth_residual_restrict_var_plain(
                    u, b, omegas, [1, 2], c, R_TAPS, red_black=red_black),
                var_leg_bound(shape, 2, "down")),
            VAR_LEGS[1]: (
                lambda: rbgs_var.prolong_correct_postsmooth_var(
                    u, e, b, omegas, [0, 1], c, P_TAPS,
                    red_black=red_black),
                lambda: rbgs_var.prolong_correct_postsmooth_var_plain(
                    u, e, b, omegas, [0, 1], c, P_TAPS,
                    red_black=red_black),
                var_leg_bound(shape, 1, "up")),
        }
        for name, (kern, plain, (bound, by)) in timed.items():
            k, p, turns = time_pair(torch, kern, plain)
            log(f"[kernels-var] {name} {mode} {n}x{m}: kernel "
                f"{turns[1]:.4f}/{turns[2]:.4f} ms, plain {turns[0]:.4f}/"
                f"{turns[3]:.4f} ms, bound {bound:.4f} ms ({by}); kernel "
                f"queued {time_ms_queued(torch, kern):.4f} ms")
            if red_black and stats is not None:
                stats[name].update(ms=k, plain_ms=p, bound_ms=bound,
                                   bound_by=by)


def check_sweep_info(tag, module, **kw):
    """The windowed red-black sweep of ``module`` (``sweep_info(**kw)``):
    its tile, halo, threads, blocks per SM, registers, local memory
    (spills) and shared memory, from the card.  Tile, halo and threads
    must be the wrapper module's; at least the blocks per SM it states
    must be resident; nothing may spill."""
    i = module.sweep_info(**kw)
    what = "red-black sweep" + "".join(f" {k}={v}" for k, v in kw.items())
    log(f"[{tag}] {what}: tile {i['tile_rows']}x{i['tile_cols']}, "
        f"halo {i['halo']}, {i['threads']} threads, {i['blocks_per_sm']} "
        f"blocks/SM, {i['registers']} registers, {i['local_bytes']} B "
        f"local, {i['smem_bytes']} B shared")
    tile = module.sweep_tile()
    want = {"tile_rows": tile[0], "tile_cols": tile[1],
            "halo": module.SWEEP_HALO, "threads": module.SWEEP_THREADS,
            "local_bytes": 0}
    check(all(i[k] == v for k, v in want.items())
          and i["blocks_per_sm"] >= module.SWEEP_BLOCKS_PER_SM,
          f"{tag} {what} info {i} against the wrapper's {want}, "
          f"{module.SWEEP_BLOCKS_PER_SM} blocks/SM")


def time_var_sweeps(torch, rbgs_var, device, shape, stats=None):
    """Both var sweeps with the problem's own stack at ``shape``: kernel
    and plain in turns (time_pair), the numbers going to ``stats`` when it
    is given; the kernel's device time alone (time_ms_queued) is logged
    beside them.  Uses only the wrappers' public signatures, so it times
    an older tree's package as well."""
    rng = np.random.default_rng(13)
    u, b = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=device) for _ in range(2))
    c = var_problem_stack(torch, shape[0], device)
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    bound, by = var_sweep_bound(shape)
    for name, om_id in zip(VAR_SWEEPS, (1, 2)):
        kern = getattr(rbgs_var, name)
        plain = getattr(rbgs_var, name + "_plain")
        timed = (lambda: kern(u, b, omegas, om_id, c),
                 lambda: plain(u, b, omegas, om_id, c))
        k, p, turns = time_pair(torch, *timed)
        log(f"[kernels-var] {name} {shape[0]}x{shape[1]}: kernel "
            f"{turns[1]:.4f}/{turns[2]:.4f} ms, plain {turns[0]:.4f}/"
            f"{turns[3]:.4f} ms, bound {bound:.4f} ms ({by}); kernel queued "
            f"{time_ms_queued(torch, timed[0]):.4f} ms")
        if stats is not None:
            stats[name].update(ms=k, plain_ms=p, bound_ms=bound, bound_by=by)


def check_var_leg_info(rbgs_var):
    """Each instantiation of the two var legs (leg, sweeps, mode): its
    tile, halo, threads, blocks per SM, registers, local memory (spills)
    and shared memory, from the card; all but the registers and shared
    memory must be the wrapper module's, and nothing may spill."""
    for leg in ("down", "up"):
        for sweeps in (1, 2, 3):
            for red_black in (True, False):
                i = rbgs_var.leg_info(leg, sweeps, red_black)
                mode = "RB" if red_black else "Jacobi"
                log(f"[kernels-var] {leg}-leg S={sweeps} {mode}: tile "
                    f"{i['tile_rows']}x{i['tile_cols']}, halo {i['halo']}, "
                    f"{i['threads']} threads, {i['blocks_per_sm']} blocks/SM,"
                    f" {i['registers']} registers, {i['local_bytes']} B "
                    f"local, {i['smem_bytes']} B shared")
                tile = rbgs_var.leg_tile(leg, sweeps, red_black)
                want = {"tile_rows": tile[0], "tile_cols": tile[1],
                        "halo": rbgs_var.leg_halo(leg, sweeps, red_black),
                        "threads": rbgs_var.LEG_THREADS,
                        "blocks_per_sm": rbgs_var.LEG_BLOCKS_PER_SM,
                        "local_bytes": 0}
                check(all(i[k] == v for k, v in want.items()),
                      f"var {leg}-leg S={sweeps} {mode} info {i} against "
                      f"the wrapper's {want}")


def phase_kernels_var(torch, rbgs_var, device):
    """The variable-coefficient kernels against their plain versions; the
    sweeps and the legs timed in turns at every level of the main path."""
    stats = {name: {"max_abs_err": 0.0} for name in VAR_SWEEPS + VAR_LEGS}
    check_var_leg_info(rbgs_var)
    check_sweep_info("kernels-var", rbgs_var)
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(6)

    def normal(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device=device)

    def note(name, tag, k, p):
        """k against p within TOL_VAR * max |p|."""
        err, excess = deviation(torch, k, p, 0.0,
                                TOL_VAR * float(p.abs().max()))
        log(f"[kernels-var] {name} {tag}: max|d| {err:.3e} (tol {TOL_VAR} "
            "max|plain|)")
        check(excess <= 0, f"{name} {tag}")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)

    for shape, kind in VAR_CASES:
        n, m = shape
        c = var_problem_stack(torch, n, device) if kind == "problem" \
            else aniso_stack(torch, shape, rng, device)
        u, b = normal(n, m), normal(n, m)
        tag = f"{n}x{m} {kind}"
        for name in VAR_SWEEPS:
            kern, plain = (getattr(rbgs_var, name + sfx)
                           for sfx in ("", "_plain"))
            note(name, tag, kern(u, b, omegas, 1, c),
                 plain(u, b, omegas, 1, c))
        if n % 2 and m % 2:
            e = normal((n - 1) // 2, (m - 1) // 2)
            for sweeps in (1, 2, 3):
                for red_black in (True, False):
                    mode = (f"{tag} S={sweeps} "
                            f"{'RB' if red_black else 'Jacobi'}")
                    ids = [1, 2, 3][:sweeps]
                    down = rbgs_var.presmooth_residual_restrict_var
                    (us_k, rc_k), (us_p, rc_p) = (
                        fn(u, b, omegas, ids, c, R_TAPS_ASYM,
                           red_black=red_black)
                        for fn in (down, rbgs_var.
                                   presmooth_residual_restrict_var_plain))
                    note(VAR_LEGS[0], mode + " u", us_k, us_p)
                    note(VAR_LEGS[0], mode + " rc", rc_k, rc_p)
                    ids = [0, 1, 2, 3][:sweeps + 1]
                    up = rbgs_var.prolong_correct_postsmooth_var
                    o_k, o_p = (
                        fn(u, e, b, omegas, ids, c, P_TAPS_ASYM,
                           red_black=red_black)
                        for fn in (up, rbgs_var.
                                   prolong_correct_postsmooth_var_plain))
                    note(VAR_LEGS[1], mode, o_k, o_p)
    for n in LEVELS_2047:
        time_var_sweeps(torch, rbgs_var, device, (n, n),
                        stats if n == LEVELS_2047[0] else None)
        time_var_legs(torch, rbgs_var, device, (n, n),
                      stats if n == LEVELS_2047[0] else None)
    return stats


def sys_sweep_flops(coeffs, minv):
    """float32 operations per point of one system sweep (every point of
    every field updated once) with this table: per field, a product for
    each nonzero coefficient and the sums, b - A u, the point solve's
    products and sums, omega times it and the update's sum."""
    flops = 0
    for i, row in enumerate(coeffs):
        nnz = sum(1 for block in row for c in block if c != 0.0)
        solve = sum(1 for v in minv[i] if v != 0.0)
        flops += 2 * nnz + 2 * solve + 2
    return flops


def sys_sweep_bound(shape, coeffs, minv):
    """A system sweep reads u and b and writes u of every field once
    (float32)."""
    points = int(np.prod(shape))
    return bytes_bound(3 * 4 * len(coeffs) * points,
                       sys_sweep_flops(coeffs, minv) * points)


def sys_leg_bound(shape, sweeps, leg, coeffs, minv):
    """A system leg moves what its sweeps move (u, b, u out of every
    field) and every field's coarse array once; it does ``sweeps`` sweeps
    and, per field, the work of LEG_FLOPS."""
    fine = int(np.prod(shape))
    coarse = int(np.prod([(n - 1) // 2 for n in shape]))
    F = len(coeffs)
    return bytes_bound(4 * F * (3 * fine + coarse),
                       fine * (sweeps * sys_sweep_flops(coeffs, minv)
                               + F * LEG_FLOPS[(leg, 2)]))


def elasticity_table(n):
    """(coeffs, minv) of linear_elasticity_2d's operator at n^2 with the
    collective point solve, as the lowering derives them."""
    from evostencils_tpu_torch.compiler import lower
    from evostencils_tpu_torch.problems.elasticity import linear_elasticity_2d
    level = (n + 1).bit_length() - 1
    op = linear_elasticity_2d(max_level=level, min_level=level - 1) \
        .level_contexts[0].operator
    coeffs = lower._sys_nine_table(op)[0]
    return coeffs, lower._Lowering._sys_minv(coeffs, "elem")


def random_sys_table(rng):
    """A diagonally dominant 2 x 2 table of 9-point blocks with nonzero
    corners in every block and nonzero off-diagonal centers, so that its
    point solve is not diagonal and a swapped (i, j) shows; with center
    fixups on two rows and their point-solve deltas."""
    from evostencils_tpu_torch.compiler import lower
    coeffs = []
    for i in range(2):
        row = []
        for j in range(2):
            c = rng.uniform(-0.3, 0.3, 9)
            c[0] = 6.0 + rng.uniform(0, 1) if i == j else 0.7 + 0.2 * i
            c[1:5] += ANISO[1:] if i == j else 0.0
            row.append(tuple(float(v) for v in c))
        coeffs.append(tuple(row))
    coeffs = tuple(coeffs)
    minv = lower._Lowering._sys_minv(coeffs, "elem")
    exc = ((3, ((0.5, 0.25), (-0.2, 0.75))), (100, ((-0.4, 0.0), (0.3, 0.6))))
    return coeffs, minv, exc, lower._Lowering._sys_minv_exc(coeffs, "elem",
                                                            exc, minv)


def split_table(n):
    """(coeffs, minv, exc, exc_minv) of helmholtz_2d_split's operator at
    n^2 (k = 80) with the collective point solve, as the lowering derives
    them: the Robin fold's center fixups and their point-solve deltas on
    rows 0 and n - 1."""
    from evostencils_tpu_torch.compiler import lower
    from evostencils_tpu_torch.problems.helmholtz import helmholtz_2d_split
    level = (n + 1).bit_length() - 1
    op = helmholtz_2d_split(max_level=level, min_level=level - 1) \
        .level_contexts[0].operator
    coeffs, exc = lower._sys_nine_table(op)
    minv = lower._Lowering._sys_minv(coeffs, "elem")
    return coeffs, minv, exc, lower._Lowering._sys_minv_exc(coeffs, "elem",
                                                            exc, minv)


#: the [kernels-sys] shapes and tables: the main path's two finest levels
#: and the evaluator's level with elasticity's own table, the split
#: Helmholtz path's finest and coarsest gated levels with its own table
#: and fixup rows, ragged shapes with the random table, its fixups and
#: asymmetric taps (the legs take the odd one; no sweep window divides
#: 65x130's rows or columns)
SYS_CASES = [((2047, 2047), "elasticity"), ((1023, 1023), "elasticity"),
             ((255, 255), "elasticity"), ((2047, 2047), "split"),
             ((255, 255), "split"), ((1025, 771), "random"),
             ((300, 200), "random"), ((65, 130), "random")]
#: the shapes the legs and sweeps are timed at: the main path's finest
#: level (its red-black numbers go to the kernels line) and the level of
#: [evaluator-elast] and [evolve-elast]
SYS_TIMED = ((2047, 2047), (255, 255))


def time_sys_legs(torch, rbgs_sys, device, shape, stats=None):
    """Both legs of the V(2,1) (2 sweeps down, 1 up) with elasticity's
    table at ``shape``, red-black and Jacobi: kernel and plain in turns
    as the other kernels are timed (time_pair); the red-black numbers go
    to ``stats`` when it is given.  The kernel's device time alone
    (time_ms_queued, without the wrapper's host work that time_pair
    counts) is logged beside them.  Uses only the wrappers' public
    signatures, so it times an older tree's package as well."""
    rng = np.random.default_rng(11)
    n, m = shape

    def normal(*s):
        return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                  device=device) for _ in range(2))

    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    op = elasticity_table(n)
    u, b = normal(n, m), normal(n, m)
    e = normal((n - 1) // 2, (m - 1) // 2)
    for red_black in (True, False):
        mode = "RB" if red_black else "Jacobi"
        timed = {
            SYS_LEGS[0]: (
                lambda: rbgs_sys.presmooth_residual_restrict_sys(
                    u, b, omegas, [1, 2], *op, R_TAPS, red_black=red_black),
                lambda: rbgs_sys.presmooth_residual_restrict_sys_plain(
                    u, b, omegas, [1, 2], *op, R_TAPS, red_black=red_black),
                sys_leg_bound(shape, 2, "down", *op)),
            SYS_LEGS[1]: (
                lambda: rbgs_sys.prolong_correct_postsmooth_sys(
                    u, e, b, omegas, [0, 1], *op, P_TAPS,
                    red_black=red_black),
                lambda: rbgs_sys.prolong_correct_postsmooth_sys_plain(
                    u, e, b, omegas, [0, 1], *op, P_TAPS,
                    red_black=red_black),
                sys_leg_bound(shape, 1, "up", *op)),
        }
        for name, (kern, plain, bound) in timed.items():
            k, p, turns = time_pair(torch, kern, plain)
            log(f"[kernels-sys] {name} {mode} {n}x{m}: kernel "
                f"{turns[1]:.4f}/{turns[2]:.4f} ms, plain {turns[0]:.4f}/"
                f"{turns[3]:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); "
                f"kernel queued {time_ms_queued(torch, kern):.4f} ms")
            if red_black and stats is not None:
                stats[name].update(ms=k, plain_ms=p, bound_ms=bound[0],
                                   bound_by=bound[1])


def log_leg_info(rbgs_sys):
    """Each leg instantiation's halo, resident blocks per SM, registers,
    local memory (spills) and shared memory, from the card."""
    for leg in ("down", "up"):
        for sweeps in (1, 2, 3):
            for red_black in (True, False):
                for fixups in (False, True):
                    i = rbgs_sys.leg_info(leg, sweeps, red_black, fixups)
                    log(f"[kernels-sys] {leg}-leg S={sweeps} "
                        f"{'RB' if red_black else 'Jacobi'} "
                        f"{'fixups' if fixups else 'no fixups'}: halo "
                        f"{i['halo']}, {i['blocks_per_sm']} blocks/SM "
                        f"({i['blocks_per_sm'] * 16} warps), "
                        f"{i['registers']} registers, {i['local_bytes']} B "
                        f"local, {i['smem_bytes']} B shared")


def phase_kernels_sys(torch, rbgs_sys, device):
    """The coupled-system kernels against their plain versions; sweeps and
    legs timed in turns at 2047^2, the main path's finest level, and at
    255^2, the evaluator's."""
    for fixups in (False, True):
        check_sweep_info("kernels-sys", rbgs_sys, fixups=fixups)
    stats = {name: {"max_abs_err": 0.0} for name in SYS_SWEEPS + SYS_LEGS}
    omegas = torch.tensor([0.9, 1.15, 0.8, 1.3], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(7)

    def normal(*s):
        return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                  device=device) for _ in range(2))

    def note(name, tag, ks, ps):
        """Every field of ks against ps within TOL_SYS * max |p|."""
        for f, (k, p) in enumerate(zip(ks, ps)):
            scale = float(p.abs().max())
            err, excess = deviation(torch, k, p, 0.0, TOL_SYS * scale)
            log(f"[kernels-sys] {name} {tag} field {f}: max|d| {err:.3e} = "
                f"{err / scale:.3e} max|plain| (tol {TOL_SYS})")
            check(excess <= 0, f"{name} {tag} field {f}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)

    for shape, kind in SYS_CASES:
        n, m = shape
        if kind == "elasticity":
            (coeffs, minv), exc, exc_minv = elasticity_table(n), (), ()
            r_taps, p_taps = R_TAPS, P_TAPS
        elif kind == "split":
            coeffs, minv, exc, exc_minv = split_table(n)
            r_taps, p_taps = R_TAPS, P_TAPS
            log(f"[kernels-sys] split {n}x{m}: center {coeffs[0][0][0]:.6g} "
                f"{coeffs[0][1][0]:+.6g}; fixup rows "
                f"{[r for r, _ in exc]}: {exc}; point-solve deltas "
                f"{exc_minv}")
            check([r for r, _ in exc] == [r for r, _ in exc_minv]
                  == [0, n - 1], f"split {n}x{m}: fixups on rows 0 and n-1")
        else:
            coeffs, minv, exc, exc_minv = random_sys_table(rng)
            r_taps, p_taps = R_TAPS_ASYM, P_TAPS_ASYM
        op = (coeffs, minv)
        fix = {"exc": exc, "exc_minv": exc_minv}
        u, b = normal(n, m), normal(n, m)
        tag = f"{n}x{m} {kind}"
        for name in SYS_SWEEPS:
            kern, plain = (getattr(rbgs_sys, name + sfx)
                           for sfx in ("", "_plain"))
            note(name, tag, kern(u, b, omegas, 1, *op, exc, exc_minv),
                 plain(u, b, omegas, 1, *op, exc, exc_minv))
        if n % 2 and m % 2:
            e = normal((n - 1) // 2, (m - 1) // 2)
            for sweeps in (1, 2, 3):
                for red_black in (True, False):
                    mode = (f"{tag} S={sweeps} "
                            f"{'RB' if red_black else 'Jacobi'}")
                    ids = [1, 2, 3][:sweeps]
                    (us_k, rc_k), (us_p, rc_p) = (
                        fn(u, b, omegas, ids, *op, r_taps,
                           red_black=red_black, **fix)
                        for fn in (rbgs_sys.presmooth_residual_restrict_sys,
                                   rbgs_sys.
                                   presmooth_residual_restrict_sys_plain))
                    note(SYS_LEGS[0], mode + " u", us_k, us_p)
                    note(SYS_LEGS[0], mode + " rc", rc_k, rc_p)
                    ids = [0, 1, 2, 3][:sweeps + 1]
                    o_k, o_p = (
                        fn(u, e, b, omegas, ids, *op, p_taps,
                           red_black=red_black, **fix)
                        for fn in (rbgs_sys.prolong_correct_postsmooth_sys,
                                   rbgs_sys.
                                   prolong_correct_postsmooth_sys_plain))
                    note(SYS_LEGS[1], mode, o_k, o_p)
        if shape not in SYS_TIMED or kind != "elasticity":
            continue
        # the main path's finest level and the evaluator's: the table, the
        # sweeps (the first level's numbers go to the kernels line)
        timed = {
            "fused_rbgs_sweep_sys": (
                lambda: rbgs_sys.fused_rbgs_sweep_sys(u, b, omegas, 1, *op),
                lambda: rbgs_sys.fused_rbgs_sweep_sys_plain(u, b, omegas, 1,
                                                            *op),
                sys_sweep_bound(shape, *op)),
            "jacobi_sweep_sys": (
                lambda: rbgs_sys.jacobi_sweep_sys(u, b, omegas, 2, *op),
                lambda: rbgs_sys.jacobi_sweep_sys_plain(u, b, omegas, 2, *op),
                sys_sweep_bound(shape, *op)),
        }
        for name, (kern, plain, bound) in timed.items():
            time_standalone(torch, stats, name, "kernels-sys", shape, kern,
                            plain, bound, keep=SYS_TIMED[0])
    log_leg_info(rbgs_sys)
    for shape in SYS_TIMED:
        time_sys_legs(torch, rbgs_sys, device, shape,
                      stats if shape == SYS_TIMED[0] else None)
    return stats


def cx_sweep_bound(shape):
    """A complex sweep reads u and b and writes u once (complex64, 8 bytes
    a value) and does CX_SWEEP_FLOPS float32 operations a point."""
    points = int(np.prod(shape))
    return bytes_bound(3 * 8 * points, CX_SWEEP_FLOPS * points)


def shifted_laplace_values(n):
    """(center, up, down, left, right) of the shifted Laplacian
    -Lap - k^2 (1 + 0.5i) at n^2 (k = 80), the [main-cx] path's stencil."""
    from evostencils_tpu_torch.grids import unit_interval_grid
    from evostencils_tpu_torch.ops.kernels import rbgs_cx
    from evostencils_tpu_torch.problems import helmholtz
    grid = unit_interval_grid(2, (n + 1).bit_length() - 1)
    return rbgs_cx.complex_five_point_values(helmholtz._helmholtz_stencil(
        grid, helmholtz.K_DEFAULT, helmholtz.SHIFT))


#: the [kernels-cx] shapes and stencils: the main path's levels with its
#: shifted Laplacian (the two finest with the JAX test's stencil too), the
#: JAX test's ragged shapes (tests/test_pallas_cx.py:39-40) with the latter
CX_CASES = [((2047, 2047), ("path", "jax")), ((1023, 1023), ("path", "jax")),
            ((511, 511), ("path",)), ((255, 255), ("path",)),
            ((300, 200), ("jax",)), ((129, 130), ("jax",))]


def phase_kernels_cx(torch, rbgs_cx, device):
    """The complex sweep kernels against their plain versions; both timed
    in turns at every level of the main path, with their device time
    beside."""
    stats = {name: {"max_abs_err": 0.0} for name in CX_SWEEPS}
    check_sweep_info("kernels-cx", rbgs_cx)
    # the fused sweep reads omega 0.6, the Jacobi sweep 0.8
    omegas = torch.tensor([0.9, 0.6, 0.8], dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(8)

    def normal(shape):
        return torch.tensor(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape),
                            dtype=torch.complex64, device=device)

    def note(name, tag, k, p):
        """k against p within TOL_CX * max |p|."""
        scale = float(p.abs().max())
        err, excess = deviation(torch, k, p, 0.0, TOL_CX * scale)
        log(f"[kernels-cx] {name} {tag}: max|d| {err:.3e} = "
            f"{err / scale:.3e} max|plain| (tol {TOL_CX})")
        check(excess <= 0, f"{name} {tag}")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)

    for shape, kinds in CX_CASES:
        u, b = normal(shape), normal(shape)
        for kind in kinds:
            vals = shifted_laplace_values(shape[0]) if kind == "path" \
                else VALS_CX
            tag = f"{shape[0]}x{shape[1]} {kind}"
            for name, om_id in zip(CX_SWEEPS, (1, 2)):
                note(name, tag,
                     getattr(rbgs_cx, name)(u, b, omegas, om_id, vals),
                     getattr(rbgs_cx, name + "_plain")(u, b, omegas, om_id,
                                                       vals))
    for n in LEVELS_2047:
        time_cx_sweeps(torch, rbgs_cx, device, (n, n),
                       stats if n == LEVELS_2047[0] else None)
    return stats


def time_cx_sweeps(torch, rbgs_cx, device, shape, stats=None):
    """Both complex sweeps with the [main-cx] path's shifted Laplacian at
    ``shape``: kernel and plain in turns (time_pair), the numbers going to
    ``stats`` when it is given; the kernel's device time alone
    (time_ms_queued) is logged beside them."""
    rng = np.random.default_rng(9)
    u, b = (torch.tensor(rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape),
                         dtype=torch.complex64, device=device)
            for _ in range(2))
    omegas = torch.tensor([0.9, 0.6, 0.8], dtype=torch.float32,
                          device=device)
    vals = shifted_laplace_values(shape[0])
    bound, by = cx_sweep_bound(shape)
    for name in CX_SWEEPS:
        kern = getattr(rbgs_cx, name)
        plain = getattr(rbgs_cx, name + "_plain")
        timed = (lambda: kern(u, b, omegas, 1, vals),
                 lambda: plain(u, b, omegas, 1, vals))
        k, p, turns = time_pair(torch, *timed)
        log(f"[kernels-cx] {name} {shape[0]}x{shape[1]}: kernel "
            f"{turns[1]:.4f}/{turns[2]:.4f} ms, plain {turns[0]:.4f}/"
            f"{turns[3]:.4f} ms, bound {bound:.4f} ms ({by}); kernel queued "
            f"{time_ms_queued(torch, timed[0]):.4f} ms")
        if stats is not None:
            stats[name].update(ms=k, plain_ms=p, bound_ms=bound, bound_by=by)


def v21(path):
    """A fresh problem of the path and its V(2,1) cycle."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.problems import elasticity, helmholtz, poisson
    _, build, max_level, min_level, partitioning, omega, _, _ = PATHS[path]
    if build == "dirichlet_helmholtz":
        problem = helmholtz.dirichlet_helmholtz(max_level, min_level)
    elif build == "helmholtz_2d_split":
        problem = helmholtz.helmholtz_2d_split(max_level, min_level)
    else:
        module = elasticity if build == "linear_elasticity_2d" else poisson
        problem = getattr(module, build)(max_level=max_level,
                                         min_level=min_level)
    cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                    pre_smoothing=2, post_smoothing=1, omega=omega,
                    partitioning=getattr(part, partitioning),
                    coarse_operator=problem.coarsest_operator)
    return problem, cycle


#: the V(2,1) paths: (label, problem, max level, min level, partitioning,
#: omega, the kernel module whose gate admits the fused levels, the leg
#: kernels that run once per cycle on every gated level)
PATHS = {
    "2d": ("main", "poisson_2d", 12, 5, "RedBlack", 1.15, "transfer",
           ("presmooth_residual_restrict", "prolong_correct_postsmooth_col")),
    "3d": ("main3d", "poisson_3d", 8, 2, "RedBlack", 1.15, "wavefront3d",
           ("downleg_wavefront_3d", "upleg_wavefront_3d")),
    # the BASELINE suite's var-coef row (scripts/bench_suite.py:107-109,
    # :127-129) with both partitionings
    "var-jacobi": ("main-var jacobi", "poisson_2d_variable", 11, 5,
                   "Single", 0.8, "transfer", VAR_LEGS),
    "var-rb": ("main-var rb", "poisson_2d_variable", 11, 5, "RedBlack",
               1.15, "transfer", VAR_LEGS),
    # the BASELINE suite's elasticity row (scripts/bench_suite.py:111-113,
    # :145-147) with both partitionings
    "elast-rb": ("main-elast rb", "linear_elasticity_2d", 11, 4, "RedBlack",
                 1.25, "rbgs_sys", SYS_LEGS),
    "elast-jacobi": ("main-elast jacobi", "linear_elasticity_2d", 11, 4,
                     "Single", 0.8, "rbgs_sys", SYS_LEGS),
    # phase 5's cell with loop fusion and row-only legs ([main-fused])
    "2d-loop-col": ("main-fused a", "poisson_2d", 12, 5, "RedBlack", 1.15,
                    "transfer", ("presmooth_residual_restrict",
                                 "upleg_downleg_col",
                                 "prolong_correct_postsmooth_col")),
    "2d-loop-rows": ("main-fused b", "poisson_2d", 12, 5, "RedBlack", 1.15,
                     "transfer", ("presmooth_residual_rowrestrict",
                                  "upleg_downleg_fused",
                                  "prolong_correct_postsmooth")),
    "2d-rows": ("main-fused c", "poisson_2d", 12, 5, "RedBlack", 1.15,
                "transfer", ("presmooth_residual_rowrestrict",
                             "prolong_correct_postsmooth")),
    # the Dirichlet shifted-Laplace hierarchy (tests/test_pallas_cx.py:
    # 110-141) at the BASELINE suite's Helmholtz width
    # (scripts/bench_suite.py:115-121, :148-149), complex64, with the
    # reference's red-black V(2,1) at omega 0.6 (BASELINE.md:31) and its
    # Jacobi twin: the standalone complex sweeps take every smoother
    "cx-rb": ("main-cx rb", "dirichlet_helmholtz", 11, 3, "RedBlack", 0.6,
              "rbgs_cx", ("fused_rbgs_sweep_cx",)),
    "cx-jacobi": ("main-cx jacobi", "dirichlet_helmholtz", 11, 3, "Single",
                  0.6, "rbgs_cx", ("jacobi_sweep_cx",)),
    # the BASELINE suite's Helmholtz row (scripts/bench_suite.py:115-121,
    # :148-150): the Robin-folded shifted Laplacian in split-complex form,
    # float32, the collective red-black V(2,1) at omega 0.6 and its Jacobi
    # twin; the system legs take the levels of their gate with the Robin
    # fold's row fixups
    "split-rb": ("main-split rb", "helmholtz_2d_split", 11, 3, "RedBlack",
                 0.6, "rbgs_sys", SYS_LEGS),
    "split-jacobi": ("main-split jacobi", "helmholtz_2d_split", 11, 3,
                     "Single", 0.6, "rbgs_sys", SYS_LEGS)}
#: kernel launches per gated level and cycle, where a path's kernel is a
#: sweep and not a leg: the V(2,1)'s 2 pre- and 1 post-sweeps
SWEEPS_PER_LEVEL = {"cx-rb": 3, "cx-jacobi": 3}
#: the iteration cap of a path's solve to 1e-5 (phase_solve): rho is about
#: 0.77 on the complex path (40 cycles to 1e-4 at 127^2 and 511^2, float64
#: probe of the JAX package), below 0.2 on the others
SOLVE_MAX_ITERATIONS = {"cx-rb": 100, "cx-jacobi": 100, "split-rb": 100,
                        "split-jacobi": 100}
#: the [main-fused] paths' switches: (loop_fusion, fused_column_transfers)
SWITCHES = {"2d-loop-col": (True, True), "2d-loop-rows": (True, False),
            "2d-rows": (False, False)}
#: median ms per cycle of each V(2,1) path's steady batches, by label
MS_PER_CYCLE = {}


def batch_launches(path, levels):
    """Launches per batch of k_cycles(path) cycles of each leg of
    ``path`` on a hierarchy whose first ``levels`` levels the gate admits:
    one of each leg per level and cycle; with loop fusion the finest level
    runs one down-leg, K - 1 fused passes and one up-leg instead (legs
    ordered down, pass, up)."""
    legs = PATHS[path][7]
    if not SWITCHES.get(path, (False, None))[0]:
        per_level = SWEEPS_PER_LEVEL.get(path, 1)
        return {name: per_level * levels * k_cycles(path) for name in legs}
    down, fused, up = legs
    return {down: 1 + (levels - 1) * K_CYCLES, fused: K_CYCLES - 1,
            up: 1 + (levels - 1) * K_CYCLES}


def k_cycles(path):
    """Chained cycles per batch of ``path``."""
    return SPLIT_K_CYCLES if path.startswith("split") else K_CYCLES


def phase_main_path(torch, kernels, device, card, path):
    """Chained V(2,1) cycles of a path; returns its launches."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import (make_cycle_loop,
                                                      residual_norm_fn)
    from evostencils_tpu_torch.problems.poisson import build_rhs

    label, _, _, _, _, _, module, legs = PATHS[path]
    path_kernels = kernels[module]
    problem, cycle = v21(path)
    lowered = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
    # complex64 on the complex path
    b = build_rhs(problem, dtype=torch.float32, device=device)
    omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                          device=device)
    u = tuple(torch.zeros_like(x) for x in b)
    n_cycles = k_cycles(path)
    loop = make_cycle_loop(lowered, n_cycles)
    # every field's points (complex unknowns on the complex path)
    n_dof = sum(int(np.prod(g.size)) for g in problem.finest_grid)

    for mod in kernels.values():
        mod.reset_launches()
    batch_ms = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u = loop(u, b, omegas)          # chained: batch j feeds batch j+1
        end.record()
        end.synchronize()
        batch_ms.append(start.elapsed_time(end))
    counts = {name: n for mod in kernels.values()
              for name, n in mod.launches.items()}
    cycles = n_cycles * BATCHES
    # every level the gate admits runs each leg once per cycle
    def admits(ctx):
        fields = tuple(torch.empty(g.size, device="meta", dtype=b[0].dtype)
                       for g in ctx.grid)
        if module == "rbgs_sys":
            return path_kernels.leg_supports(fields)
        if module == "rbgs_cx":
            return path_kernels.supports(fields[0], VALS_CX)
        return path_kernels.supports(fields[0])
    fused = sum(1 for ctx in problem.level_contexts if admits(ctx))
    log(f"[{label}] launches {counts} over {cycles} cycles, {fused} fused "
        "levels")
    # the legs take every smoother and transfer of the gated levels, so
    # no standalone kernel runs
    per_batch = batch_launches(path, fused)
    for name, count in counts.items():
        want = per_batch.get(name, 0) * BATCHES
        check(count == want, f"{name} launched {count} times on the "
              f"{label} path, expected {want}")

    steady = batch_ms[1:]
    ms_cycle = statistics.median(steady) / n_cycles
    MS_PER_CYCLE[label] = ms_cycle
    log(f"[{label}] batches of {n_cycles} cycles: "
        + ", ".join(f"{t:.1f}" for t in batch_ms) + " ms (first warms up)")
    log(f"[{label}] {n_dof} DoF: {ms_cycle:.4f} ms/cycle (median), "
        f"{min(steady) / n_cycles:.4f} (best), "
        f"{n_dof / (ms_cycle * 1e-3):.4e} DoF/s on {card}")

    u0 = u[0]
    want = torch.complex64 if module == "rbgs_cx" else torch.float32
    check(tuple(u0.shape) == tuple(problem.finest_grid[0].size)
          and u0.dtype == want, "solution shape/dtype")
    res = float(residual_norm_fn(lowered.operator)(u, b))
    rel = res / float(torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(x.abs().double())
                     for x in b])))
    log(f"[{label}] relative residual after {cycles} cycles: {rel:.3e} "
        "(gate 1e-4, bench.py:195)")
    check(np.isfinite(rel) and rel <= 1e-4, "relative residual")
    if problem.exact_solution is not None:
        exact = problem.exact_solution()[0]
        sol_err = float(np.abs(u0.double().cpu().numpy() - exact).max()
                        / np.abs(exact).max())
        log(f"[{label}] max error against the analytic solution: "
            f"{sol_err:.3e} (relative; gross gate 1e-2)")
        check(np.isfinite(sol_err) and sol_err <= 1e-2, "analytic solution")
    return {name: counts[name] for name in legs}


def phase_solve(torch, device, path):
    """make_solver to 1e-5 with the kernels and with the plain versions."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.problems.poisson import build_rhs

    label = PATHS[path][0]
    max_it = SOLVE_MAX_ITERATIONS.get(path, 20)
    problem, cycle = v21(path)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    compare_solves(torch, label, b, max_it, lambda use_kernels: lower_cycle(
        cycle, problem.approximation, problem.rhs_entity,
        use_kernels=use_kernels))


def compare_solves(torch, label, b, max_it, lower):
    """make_solver to 1e-5 from zero of ``lower(use_kernels)`` with the
    kernels and with the plain versions: equal iterations, histories within
    1e-3 above the float32 floor.  Returns the kernels' (iterations,
    relative history)."""
    from evostencils_tpu_torch.compiler.solve import make_solver

    runs = {}
    for use_kernels in (True, False):
        lowered = lower(use_kernels)
        omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                              device=b[0].device)
        u0 = tuple(torch.zeros_like(x) for x in b)
        _, k, hist = make_solver(lowered, max_it, 1e-5)(u0, b, omegas)
        hist = hist[:k + 1].double().cpu().numpy()
        runs[use_kernels] = (k, hist)
        rho = (hist[k] / hist[0]) ** (1.0 / k) if k else 0.0
        kf = min(k, 4)
        rho4 = (hist[kf] / hist[0]) ** (1.0 / kf) if kf else 0.0
        log(f"[{label} solve] {'kernels' if use_kernels else 'plain  '}: {k}"
            f" iterations to 1e-5, rho {rho:.4f}, rho(first {kf}) "
            f"{rho4:.4f}, history "
            f"{np.array2string(hist / hist[0], precision=4)}")
    (k1, h1), (k0, h0) = runs[True], runs[False]
    check(k1 == k0 and 0 < k1 < max_it, f"{label} iterations {k1} vs {k0}")
    # A float32 state cannot hold a residual much below 1e-5 * ||b||: the
    # rounding of u alone leaves |A du| of that order.  The last entry of
    # a solve to 1e-5 sits on that floor, where the kernels' and the plain
    # versions' rounding differ by a sizeable fraction of it; above it the
    # histories must agree to 1e-3.
    floor = 1e-5 * h0[0]
    rel = np.abs(h1 - h0) / h0
    above = h0 > 10 * floor
    log(f"[{label} solve] residual histories agree to "
        f"{rel[above].max():.3e} relative above 10x the float32 floor "
        f"(1e-5 ||b||), {rel.max():.3e} overall")
    check(np.all(np.abs(h1 - h0) <= 1e-3 * h0 + floor),
          f"{label} residual histories (rtol 1e-3 above 1e-5 ||b||)")
    return k1, h1 / h1[0]


def set_switches(loop_fusion, fused_columns):
    from evostencils_tpu_torch.config import config
    config.loop_fusion = loop_fusion
    config.fused_column_transfers = fused_columns


def phase_main_fused(torch, kernels, device, card):
    """Phase 5's cell with loop fusion and row-only legs; the switches are
    restored to their defaults afterwards.  Returns the launches of the
    fused passes and the row-only legs, summed over the configurations."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import make_cycle_loop
    from evostencils_tpu_torch.config import Config
    from evostencils_tpu_torch.problems.poisson import build_rhs

    defaults = Config()
    launches = {}
    try:
        for path in ("2d-loop-col", "2d-loop-rows", "2d-rows"):
            set_switches(*SWITCHES[path])
            for name, count in phase_main_path(torch, kernels, device, card,
                                               path).items():
                if name in LOOP_KERNELS:
                    launches[name] = launches.get(name, 0) + count
        # K fused cycles against K steps, in each column mode
        problem, cycle = v21("2d")
        lowered = lower_cycle(cycle, problem.approximation,
                              problem.rhs_entity)
        b = build_rhs(problem, dtype=torch.float32, device=device)
        omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                              device=device)
        u0 = tuple(torch.zeros_like(x) for x in b)
        for path in ("2d-loop-col", "2d-loop-rows"):
            for k in (1, 2, 8):
                set_switches(*SWITCHES[path])
                fused = make_cycle_loop(lowered, k)(u0, b, omegas)
                set_switches(False, SWITCHES[path][1])
                ref = u0
                for _ in range(k):
                    ref = lowered.step(ref, b, omegas)
                err = float((fused[0] - ref[0]).abs().max())
                scale = float(ref[0].abs().max())
                log(f"[{PATHS[path][0]}] {k} fused cycles against {k} "
                    f"steps: max|du| {err:.3e} = {err / scale:.3e} max|u| "
                    "(tol 3e-5, tests/test_fused_loop.py:48-51)")
                check(err <= 3e-5 * scale, f"{path}: {k} fused cycles")
        set_switches(*SWITCHES["2d-rows"])
        phase_solve(torch, device, "2d-rows")
    finally:
        set_switches(defaults.loop_fusion, defaults.fused_column_transfers)
    labels = [PATHS[p][0] for p in ("2d-loop-col", "2d-loop-rows",
                                    "2d-rows")] + [PATHS["2d"][0]]
    log("[main-fused] ms/cycle at 4095^2: " + ", ".join(
        f"{lab} {MS_PER_CYCLE[lab]:.4f}" for lab in labels)
        + " (main = d: loop fusion off, fused column transfers) on "
        + card)
    return launches


#: the [evaluator] phase: poisson_2d(10, 5) (1023^2), the repetitions of
#: measure_interleaved, and the TPU's rho for the gen-75 champion and the
#: red-black V(2,1) at 1023^2 in float32 (VERDICT.md:34-36), printed for
#: reference only
EVAL_LEVELS = (10, 5)
EVAL_REPS = 5
TPU_RHO = {"gen75": 0.0118, "rb_v21": 0.0183}
#: repetitions of the timing protocol in the [evolve] and [evolve-var]
#: runs; [evolve3d], [evolve-elast] and [evolve-helm] run with it off, for
#: the script's time
EVOLVE_TIMING_REPS = 1
#: mu and lambda of every [evolve*] run: 4 * mu initial candidates and
#: lambda offspring; 2 keeps the whole script well inside its time, the
#: evolution phases being about half of it
EVOLVE_POPULATION = 2


def counts_of(kernels):
    return {name: n for mod in kernels.values()
            for name, n in mod.launches.items()}


def reset(kernels):
    for mod in kernels.values():
        mod.reset_launches()


def champion(key, fitness):
    """The entry of ``key`` in results/evolved_champions.json with the
    lowest ``fitness`` value (picked by fitness, not by position)."""
    entries = json.loads((ROOT / "results" / "evolved_champions.json")
                         .read_text())[key]
    best = min(range(len(entries)), key=lambda i: entries[i][fitness])
    return best, entries[best]["grammar"]


def evaluator_structures(problem):
    """(key, expression) of the four structures the phase measures."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.ir import transformations

    def hand(partitioning, omega):
        return v_cycle(problem.level_contexts, problem.rhs_entity,
                       pre_smoothing=2, post_smoothing=1, omega=omega,
                       partitioning=partitioning,
                       coarse_operator=problem.coarsest_operator)

    pset = generate_primitive_set(problem.approximation, problem.rhs_entity,
                                  problem.level_contexts,
                                  problem.coarsest_operator)[0]
    out = [("rb_v21", hand(part.RedBlack, 1.15)),
           ("jacobi_v21", hand(part.Single, 0.8))]
    for key, json_key, fitness in (
            ("gen75", "poisson2d_1023sq_seeded_gen75", "est_t_conv_ms"),
            ("gen50", "poisson2d_1023sq_seeded_gen50", "fitness_ms_per_iter")):
        index, grammar = champion(json_key, fitness)
        log(f"[evaluator] {key}: {json_key}[{index}], the lowest {fitness}")
        expr = gp.compile_tree(gp.parse_tree(grammar, pset), pset)[0]
        transformations.assign_cycle_ids(expr)
        out.append((key, expr))
    return out


def solve_history(torch, lowered, b, max_iterations, reduction):
    """(iterations, residual history) of one solve from zero, as the
    evaluator runs it."""
    from evostencils_tpu_torch.compiler.solve import make_solver
    om = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                      device=b[0].device)
    u0 = tuple(torch.zeros_like(x) for x in b)
    _, k, hist = make_solver(lowered, max_iterations, reduction)(u0, b, om)
    return k, hist[:k + 1].double().cpu().numpy()


def measure_structures(torch, kernels, tag, evaluator, structures, names,
                       card, reps=EVAL_REPS):
    """measure_interleaved over ``structures`` with the counts set to 0
    just before; each kernel of ``names`` must launch and each structure
    converge.  Returns (results by key, launches)."""
    reset(kernels)
    t0 = time.perf_counter()
    results = evaluator.measure_interleaved(structures, reps=reps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_of(kernels)
    log(f"[{tag}] measure_interleaved over {len(structures)} structures "
        f"x {reps} reps in {wall:.1f} s; launches {counts}")
    for name in names:
        check(counts[name] > 0, f"{name} never launched on the {tag} path")
    for r in results:
        lo, hi = r["ms_per_iter_spread"]
        log(f"[{tag}] {r['key']}: rho {r['convergence_factor']:.5f}, "
            f"{r['iterations']:.0f} iterations to the "
            f"{evaluator.target_reduction:g} target (measured to "
            f"{evaluator.measurement_reduction:g}), "
            f"{r['ms_per_iter']:.4f} ms/iteration "
            f"(spread {lo:.4f}..{hi:.4f}), time to convergence "
            f"{r['time_to_convergence_ms']:.3f} ms on {card}")
        check(np.isfinite(r["convergence_factor"])
              and r["convergence_factor"] < 1, f"{r['key']} converges")
    return {r["key"]: r for r in results}, counts


def check_structure(torch, kernels, tag, key, expr, evaluator, b, want):
    """One cycle of ``expr`` alone must launch exactly ``want`` (the
    nonzero counts; None: not checked); then the kernels against their
    plain versions over a whole solve from zero to the right-hand side
    ``b``: the same iterations, and histories that agree to 1e-3 above the
    float32 floor of 1e-5 * ||b|| (phase_solve), where the last entry of a
    solve to 1e-5 sits."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle

    problem = evaluator.problem
    lowered = lower_cycle(expr, problem.approximation, problem.rhs_entity)
    om = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                      device=b[0].device)
    reset(kernels)
    lowered.step(tuple(torch.zeros_like(x) for x in b), b, om)
    per_cycle = {k: n for k, n in counts_of(kernels).items() if n}
    log(f"[{tag}] {key}: launches per cycle {per_cycle}")
    if want is not None:
        check(per_cycle == want, f"{key} launches {per_cycle} per cycle, "
              f"expected {want}")
    (k1, h1), (k0, h0) = (
        solve_history(torch, lower_cycle(
            expr, problem.approximation, problem.rhs_entity,
            use_kernels=use), b, evaluator.max_iterations,
            evaluator.measurement_reduction)
        for use in (True, False))
    rho1, rho0 = ((h[-1] / h[0]) ** (1.0 / (len(h) - 1)) for h in (h1, h0))
    log(f"[{tag}] {key}: kernels {k1} iterations rho {rho1:.6f}, "
        f"plain {k0} iterations rho {rho0:.6f} (to 1e-5)")
    check(k1 == k0, f"{key}: {k1} iterations with the kernels, {k0} "
          "with the plain versions")
    floor = 1e-5 * h0[0]
    rel = np.abs(h1 - h0) / h0
    log(f"[{tag}] {key}: histories agree to "
        f"{rel[h0 > 10 * floor].max():.3e} relative above 10x the "
        f"float32 floor (1e-5 ||b||), {rel.max():.3e} overall")
    check(np.all(np.abs(h1 - h0) <= 1e-3 * h0 + floor),
          f"{key}: residual histories (rtol 1e-3 above 1e-5 ||b||)")


def phase_evaluator(torch, kernels, device, card):
    """The evolution path's measured evaluator on the card; returns the
    standalone kernels' launches over its measure_interleaved run."""
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.problems.poisson import build_rhs, poisson_2d

    problem = poisson_2d(max_level=EVAL_LEVELS[0], min_level=EVAL_LEVELS[1])
    evaluator = CycleEvaluator(problem, dtype=np.float32, device=device)
    structures = evaluator_structures(problem)
    by_key, counts = measure_structures(torch, kernels, "evaluator",
                                        evaluator, structures, STANDALONE,
                                        card)
    # the Jacobi V(2,1): 3 sweeps on each of 1023^2, 511^2, 255^2; one
    # transfer pair each (the 127^2 level is below both gates)
    want = {"jacobi_v21": {"jacobi_sweep": 9, "residual_restrict": 3,
                           "prolong_correct": 3}}
    b = build_rhs(problem, dtype=torch.float32, device=device)
    for key, expr in structures:
        check_structure(torch, kernels, "evaluator", key, expr, evaluator, b,
                        want.get(key))
    rho75, rho_rb = (by_key[k]["convergence_factor"]
                     for k in ("gen75", "rb_v21"))
    log(f"[evaluator] gen-75 champion rho {rho75:.5f} vs red-black V(2,1) "
        f"{rho_rb:.5f} (on the TPU, VERDICT.md:34-36: {TPU_RHO['gen75']} "
        f"vs {TPU_RHO['rb_v21']}, not a gate)")
    check(rho75 < rho_rb, "the gen-75 champion converges faster than the "
          "red-black V(2,1)")
    return {name: counts[name] for name in STANDALONE}


#: the [evaluator3d] structures: (pre-sweeps, post-sweeps, partitioning,
#: omega), and the launches of one cycle at 255^3 (levels 8 -> 2): the
#: wavefront legs take 255^3, 127^3 and 63^3 of an RB V(2,1); elsewhere the
#: rbgs3d sweeps take 127^3 and 63^3, the leg3d sweeps 255^3, the leg3d
#: transfers all three; 31^3 and below run the generic lowering
EVAL3D_STRUCTURES = {
    "rb_v21": ((2, 1, "RedBlack", 1.15),
               {"downleg_wavefront_3d": 3, "upleg_wavefront_3d": 3}),
    "rb_v11": ((1, 1, "RedBlack", 1.15),
               {"fused_rbgs_sweep_3d2": 1, "fused_rbgs_sweep_3d": 2,
                "residual_restrict_3d": 3, "upleg_wavefront_3d": 3}),
    "jacobi_v21": ((2, 1, "Single", 0.8),
                   {"jacobi_sweep_3d2": 3, "jacobi_sweep_3d": 6,
                    "residual_restrict_3d": 3, "prolong_correct_3d": 3}),
}


def phase_evaluator_3d(torch, kernels, device, card):
    """The evaluator on the 3D path at 255^3; returns the 3D standalone
    kernels' launches over its measure_interleaved run."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.problems.poisson import build_rhs, poisson_3d

    problem = poisson_3d(max_level=8, min_level=2)
    evaluator = CycleEvaluator(problem, dtype=np.float32, device=device)
    structures = []
    for key, ((pre, post, partitioning, omega), _) in \
            EVAL3D_STRUCTURES.items():
        structures.append((key, v_cycle(
            problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
            post_smoothing=post, omega=omega,
            partitioning=getattr(part, partitioning),
            coarse_operator=problem.coarsest_operator)))
    _, counts = measure_structures(torch, kernels, "evaluator3d", evaluator,
                                   structures, STANDALONE3, card)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    for key, expr in structures:
        check_structure(torch, kernels, "evaluator3d", key, expr, evaluator,
                        b, EVAL3D_STRUCTURES[key][1])
    return {name: counts[name] for name in STANDALONE3}


#: the [evaluator-var] structures, as EVAL3D_STRUCTURES, at 1023^2
#: (levels 10 -> 5): the var legs take 1023^2, 511^2 and 255^2 with up to
#: three sweeps each, so a V(4,4) leaves one pre- and one post-sweep per
#: level to the standalone sweeps
EVALVAR_LEVELS = (10, 5)
EVALVAR_STRUCTURES = {
    "rb_v21": ((2, 1, "RedBlack", 1.15), {VAR_LEGS[0]: 3, VAR_LEGS[1]: 3}),
    "jacobi_v21": ((2, 1, "Single", 0.8), {VAR_LEGS[0]: 3, VAR_LEGS[1]: 3}),
    "rb_v44": ((4, 4, "RedBlack", 1.15),
               {VAR_LEGS[0]: 3, VAR_LEGS[1]: 3, "fused_rbgs_sweep_var": 6}),
    "jacobi_v44": ((4, 4, "Single", 0.8),
                   {VAR_LEGS[0]: 3, VAR_LEGS[1]: 3, "jacobi_sweep_var": 6}),
}


def phase_evaluator_var(torch, kernels, device, card):
    """The evaluator on the variable-coefficient path at 1023^2; returns
    the standalone var sweeps' launches over its measure_interleaved
    run."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.problems.poisson import (build_rhs,
                                                        poisson_2d_variable)

    problem = poisson_2d_variable(max_level=EVALVAR_LEVELS[0],
                                  min_level=EVALVAR_LEVELS[1])
    evaluator = CycleEvaluator(problem, dtype=np.float32, device=device)
    structures = []
    for key, ((pre, post, partitioning, omega), _) in \
            EVALVAR_STRUCTURES.items():
        structures.append((key, v_cycle(
            problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
            post_smoothing=post, omega=omega,
            partitioning=getattr(part, partitioning),
            coarse_operator=problem.coarsest_operator)))
    _, counts = measure_structures(torch, kernels, "evaluator-var", evaluator,
                                   structures, VAR_SWEEPS + VAR_LEGS, card)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    for key, expr in structures:
        check_structure(torch, kernels, "evaluator-var", key, expr,
                        evaluator, b, EVALVAR_STRUCTURES[key][1])
    return {name: counts[name] for name in VAR_SWEEPS}


#: the [evaluator-elast] structures at 255^2 (levels 8 -> 4): (pre-sweeps,
#: post-sweeps, partitioning, omega, smoother), and the launches of one
#: cycle: only 255^2 passes the system gates; a V(4,4) leaves one pre- and
#: one post-sweep to the standalone sweep beside legs of 3 sweeps; the
#: stored champion of lowest fitness_rho runs one standalone sweep besides
#: its legs
EVALELAST_LEVELS = (8, 4)
EVALELAST_STRUCTURES = {
    "rb_v21": ((2, 1, "RedBlack", 1.25, "collective"),
               {SYS_LEGS[0]: 1, SYS_LEGS[1]: 1}),
    "jacobi_v21": ((2, 1, "Single", 0.8, "collective"),
                   {SYS_LEGS[0]: 1, SYS_LEGS[1]: 1}),
    "rb_v44": ((4, 4, "RedBlack", 1.25, "collective"),
               {SYS_LEGS[0]: 1, SYS_LEGS[1]: 1, "fused_rbgs_sweep_sys": 2}),
    "jacobi_v44": ((4, 4, "Single", 0.8, "collective"),
                   {SYS_LEGS[0]: 1, SYS_LEGS[1]: 1, "jacobi_sweep_sys": 2}),
    "decoupled_rb_v21": ((2, 1, "RedBlack", 1.25, "decoupled"),
                         {SYS_LEGS[0]: 1, SYS_LEGS[1]: 1}),
    "gen25": (None, {SYS_LEGS[0]: 1, SYS_LEGS[1]: 1,
                     "fused_rbgs_sweep_sys": 1}),
}


def phase_evaluator_elast(torch, kernels, device, card):
    """The evaluator on the elasticity path at 255^2; returns the
    standalone system sweeps' launches over its measure_interleaved run."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.ir import smoother, transformations
    from evostencils_tpu_torch.problems.elasticity import linear_elasticity_2d
    from evostencils_tpu_torch.problems.poisson import build_rhs

    problem = linear_elasticity_2d(max_level=EVALELAST_LEVELS[0],
                                   min_level=EVALELAST_LEVELS[1])
    evaluator = CycleEvaluator(problem, dtype=np.float32, device=device)
    structures = []
    for key, (hand, _) in EVALELAST_STRUCTURES.items():
        if hand is None:
            json_key = "elasticity2d_255sq_collective_gen25"
            index, grammar = champion(json_key, "fitness_rho")
            log(f"[evaluator-elast] {key}: {json_key}[{index}], the lowest "
                "fitness_rho")
            pset = generate_primitive_set(
                problem.approximation, problem.rhs_entity,
                problem.level_contexts, problem.coarsest_operator)[0]
            expr = gp.compile_tree(gp.parse_tree(grammar, pset), pset)[0]
            transformations.assign_cycle_ids(expr)
            structures.append((key, expr))
            continue
        pre, post, partitioning, omega, kind = hand
        structures.append((key, v_cycle(
            problem.level_contexts, problem.rhs_entity, pre_smoothing=pre,
            post_smoothing=post, omega=omega,
            partitioning=getattr(part, partitioning),
            smoother_factory=getattr(smoother, f"generate_{kind}_jacobi"),
            coarse_operator=problem.coarsest_operator)))
    by_key, counts = measure_structures(torch, kernels, "evaluator-elast",
                                        evaluator, structures,
                                        SYS_SWEEPS + SYS_LEGS, card)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    for key, expr in structures:
        check_structure(torch, kernels, "evaluator-elast", key, expr,
                        evaluator, b, EVALELAST_STRUCTURES[key][1])
    it_champ, it_rb = (by_key[k]["iterations"] for k in ("gen25", "rb_v21"))
    log(f"[evaluator-elast] champion {it_champ:.0f} iterations to the 1e-12 "
        f"target (rho {by_key['gen25']['convergence_factor']:.5f}), "
        f"red-black V(2,1) {it_rb:.0f} (rho "
        f"{by_key['rb_v21']['convergence_factor']:.5f})")
    check(it_champ <= it_rb, "the gen-25 champion needs no more iterations "
          "than the red-black V(2,1)")
    return {name: counts[name] for name in SYS_SWEEPS}


#: [helm]: the wavenumbers and the JAX package's BiCGStab iterations to
#: 1e-7 at helmholtz_2d(7, 3) in CPU float64 (BASELINE.md:251-262, by
#: scripts/helmholtz_convergence.py); the port's must lie within 2%
HELM_ITERATIONS = {80.0: 265, 160.0: 1235, 320.0: 3199}
#: [evolve-helm]'s cut: the 2k and 4k robustness variants are off.  On an
#: H100 at the default levels 7 -> 3 the 16 initial evaluations of mu = 4
#: took 110 s and the variants of the finite ones 65 s more, over the
#: phase's 150 s
EVOLVE_HELM_OPTIONS = ("--no-robustness",)


def helm_cycle(problem, partitioning="RedBlack", block=False):
    """The V(2,1) at omega 0.6 of a Helmholtz problem: collective point
    Jacobi smoothing, or the 2 x 2 collective block Jacobi."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.ir import smoother

    factory = smoother.generate_collective_jacobi
    if block:
        def factory(op):
            return smoother.generate_collective_block_jacobi(op, [(2, 2)])
    return v_cycle(problem.level_contexts, problem.rhs_entity,
                   pre_smoothing=2, post_smoothing=1, omega=0.6,
                   partitioning=getattr(part, partitioning),
                   smoother_factory=factory,
                   coarse_operator=problem.coarsest_operator)


def helm_solve(torch, problem, device, dtype, graph=True):
    """(x, iterations, history, b, matvec): BiCGStab on the problem's true
    operator to its 1e-7, one red-black V(2,1) from zero per
    preconditioner application (scripts/helmholtz_convergence.py), with the
    fields in the complex dtype of ``dtype``'s precision, or for a
    split-complex problem real (re, im) fields in ``dtype`` and the split
    BiCGStab; the preconditioner is the evaluator's, replayed from a CUDA
    graph unless ``graph`` is false."""
    from evostencils_tpu_torch.compiler.lower import (lower_cycle,
                                                      operator_applier)
    from evostencils_tpu_torch.compiler.solve import make_preconditioner
    from evostencils_tpu_torch.ops.solvers import (
        preconditioned_bicgstab, preconditioned_bicgstab_split)
    from evostencils_tpu_torch.problems.poisson import build_rhs

    lowered = lower_cycle(helm_cycle(problem), problem.approximation,
                          problem.rhs_entity)
    b = build_rhs(problem, dtype=dtype, device=device)
    om = torch.tensor(lowered.default_omegas, dtype=b[0].real.dtype,
                      device=device)
    matvec = operator_applier(problem.outer_solver.operator)
    precond = make_preconditioner(lowered, om, b, graph)
    outer = problem.outer_solver
    bicgstab = preconditioned_bicgstab_split if outer.split \
        else preconditioned_bicgstab
    x, k, hist = bicgstab(
        matvec, precond, b, tol=outer.tolerance,
        maxiter=outer.max_iterations, history_size=outer.max_iterations)
    return x, k, hist.cpu().numpy(), b, matvec


def phase_helm(torch, kernels, device, card):
    """The Robin-folded Helmholtz problem's outer solve on the card at
    k = 80, 160 and 320 in complex128, and at k = 80 in complex64; no
    kernel may launch: the field form keeps the operator off the complex
    sweeps, as in the JAX package (tests/test_pallas_cx.py:153-164).
    Returns the complex128 iterations by wavenumber."""
    from evostencils_tpu_torch.problems.helmholtz import helmholtz_2d

    reset(kernels)
    iterations = {}
    for k, want in HELM_ITERATIONS.items():
        t0 = time.perf_counter()
        _, it, hist, _, _ = helm_solve(torch, helmholtz_2d(7, 3, k=k),
                                       device, torch.float64)
        wall = time.perf_counter() - t0
        log(f"[helm] k={k:g} complex128: {it} iterations to "
            f"{hist[it] / hist[0]:.3e} in {wall:.1f} s "
            f"({wall / max(it, 1) * 1e3:.2f} ms/iteration) on {card}; the "
            f"JAX package's CPU float64: {want} (BASELINE.md:251-262)")
        check(hist[it] <= 1e-7 * hist[0] and abs(it - want) <= 0.02 * want,
              f"k={k:g}: {it} iterations, the JAX package's {want}")
        iterations[k] = it
    problem = helmholtz_2d(7, 3)
    runs = {}
    for graph in (True, False):
        t0 = time.perf_counter()
        runs[graph] = helm_solve(torch, problem, device, torch.float32,
                                 graph) + (time.perf_counter() - t0,)
    x, it, hist, b, matvec, wall = runs[True]
    _, it_eager, hist_eager, _, _, wall_eager = runs[False]
    # the graph replays the eager step: equal iterations, and histories
    # within 1e-3 above the complex64 floor of 1e-5 ||b|| (phase 6's rule)
    floor = 1e-5 * hist[0]
    n = min(it, it_eager) + 1
    above = np.minimum(hist[:n], hist_eager[:n]) > floor
    dev = float(np.max(np.abs(hist[:n] - hist_eager[:n])[above]
                       / hist_eager[:n][above]))
    log(f"[helm] k=80 complex64, the preconditioner eager: {it_eager} "
        f"iterations in {wall_eager:.1f} s "
        f"({wall_eager / max(it_eager, 1) * 1e3:.2f} ms/iteration); from "
        f"the CUDA graph: {it} in {wall:.1f} s "
        f"({wall / max(it, 1) * 1e3:.2f} ms/iteration); histories within "
        f"{dev:.3e} above the floor")
    check(it == it_eager and dev <= 1e-3,
          "the graphed preconditioner matches the eager one")
    check(x[0].dtype == torch.complex64 and b[0].dtype == torch.complex64,
          "complex64 fields")
    # the true residual of the complex64 solution, in complex128
    x128 = tuple(xi.to(torch.complex128) for xi in x)
    b128 = tuple(bi.to(torch.complex128) for bi in b)
    true = float(torch.sqrt(sum(torch.sum(torch.abs(bi - ai) ** 2) for bi, ai
                                in zip(b128, matvec(x128))))
                 / torch.sqrt(sum(torch.sum(torch.abs(bi) ** 2)
                                  for bi in b128)))
    log(f"[helm] k=80 complex64: {it} iterations, recurrence residual "
        f"{hist[it] / hist[0]:.3e}, true relative residual {true:.3e}, in "
        f"{wall:.1f} s on {card}")
    check(np.isfinite(true) and it < problem.outer_solver.max_iterations,
          "the complex64 solve ends below 1e-7 by its recurrence")
    counts = counts_of(kernels)
    check(not any(counts.values()), f"kernels launched on [helm]: {counts}")
    return iterations


def phase_evaluator_helm(torch, kernels, device, card):
    """The evaluator with the outer solver on the card in float32
    (complex64 fields) at helmholtz_2d(7, 3) over the red-black and
    Jacobi V(2,1) and the 2 x 2 block-Jacobi V(2,1); no kernel launches."""
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.problems.helmholtz import helmholtz_2d

    problem = helmholtz_2d(7, 3)
    evaluator = CycleEvaluator(problem, dtype=np.float32, device=device)
    check(evaluator._b[0].dtype == torch.complex64, "complex64 fields")
    structures = [("rb_v21", helm_cycle(problem)),
                  ("jacobi_v21", helm_cycle(problem, "Single")),
                  ("block_v21", helm_cycle(problem, "Single", block=True))]
    _, counts = measure_structures(torch, kernels, "evaluator-helm",
                                   evaluator, structures, (), card)
    check(not any(counts.values()),
          f"kernels launched on [evaluator-helm]: {counts}")


def reset_peak_memory(torch):
    """Reset the device memory peak; returns the memory held now."""
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_memory(torch, tag, held):
    """Log the device memory held at the peak since reset_peak_memory,
    and how much of it came after: ``held`` is what was held then."""
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] peak device memory {peak / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated), {(peak - held) / 2**20:.1f} MiB "
        f"above the {held / 2**20:.1f} MiB held when the phase began")


def split_levels(torch, kernels, device, path):
    """One step of the split path's cycle: each system leg must run once on
    each of 2047^2 .. 255^2 with the problem's fixup rows (counted by
    level through the module's entries, which call the counted wrappers),
    the varying point solve on 127^2 and below, and no other kernel."""
    from evostencils_tpu_torch.compiler import lower
    from evostencils_tpu_torch.ops.kernels import rbgs_sys
    from evostencils_tpu_torch.problems.poisson import build_rhs

    label = PATHS[path][0]
    problem, cycle = v21(path)
    lowered = lower.lower_cycle(cycle, problem.approximation,
                                problem.rhs_entity)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    om = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                      device=device)
    seen = {name: {} for name in SYS_LEGS + ("varying",)}
    wrapped = {name: getattr(rbgs_sys, name) for name in SYS_LEGS}
    varying = lower._Lowering._pointwise_varying_inverse

    def counted(name, fn):
        def call(fields, *args, **kw):
            n = fields[0].shape[0]
            seen[name][n] = seen[name].get(n, 0) + 1
            if name != "varying":
                rows = [r for r, _ in kw["exc"]]
                check(rows == [r for r, _ in kw["exc_minv"]] == [0, n - 1],
                      f"{name} at {n}^2: fixup rows {rows}")
            return fn(fields, *args, **kw)
        return call

    for name, fn in wrapped.items():
        setattr(rbgs_sys, name, counted(name, fn))
    lower._Lowering._pointwise_varying_inverse = \
        lambda self, op, fields: counted("varying", lambda f: varying(
            self, op, f))(fields)
    reset(kernels)
    try:
        lowered.step(tuple(torch.zeros_like(x) for x in b), b, om)
        torch.cuda.synchronize()
    finally:
        for name, fn in wrapped.items():
            setattr(rbgs_sys, name, fn)
        lower._Lowering._pointwise_varying_inverse = varying
    counts = {k: n for k, n in counts_of(kernels).items() if n}
    log(f"[{label}] one cycle: launches {counts}; by level "
        f"{ {name: dict(sorted(v.items())) for name, v in seen.items()} }")
    gated = {2047: 1, 1023: 1, 511: 1, 255: 1}
    for name in SYS_LEGS:
        check(seen[name] == gated, f"{name} by level {seen[name]}")
    check(counts == {name: 4 for name in SYS_LEGS},
          f"{label}: launches per cycle {counts}")
    check(set(seen["varying"]) == {127, 63, 31, 15},
          f"the varying point solve ran at {sorted(seen['varying'])}")


def phase_main_split(torch, kernels, device, card, path):
    """[main-split]: the chained cycles and the per-level check of one
    cycle; returns the legs' launches over the chained batches."""
    held = reset_peak_memory(torch)
    launches = phase_main_path(torch, kernels, device, card, path)
    split_levels(torch, kernels, device, path)
    peak_memory(torch, PATHS[path][0], held)
    return launches


#: [helm-split]: how far the split BiCGStab's iterations may lie from
#: [helm]'s complex128 counts of the same run, by wavenumber.  The two are
#: the same algebra (JAX tests/test_split_complex.py:89), but at k = 320
#: a float64 run's count moves with its rounding: the JAX package's CPU
#: runs take 3296 (complex) and 3175 (split), the port's CPU runs 3305 and
#: 3202, by ``JAX_PLATFORMS=cpu python -c 'from tests.test_torch_split
#: import bicgstab_iterations as f; print([f(p, s, 320.0) for p in ("jax",
#: "port") for s in ("complex", "split")])'``, and on an H100 the port
#: took 3182 and 3263 (2.5% apart)
HELM_SPLIT_TOLERANCE = {80.0: 0.02, 160.0: 0.02, 320.0: 0.05}


def phase_helm_split(torch, kernels, device, card, helm_iterations):
    """helmholtz_2d_split(7, 3) in float64 at [helm]'s wavenumbers: the
    split BiCGStab's iterations within HELM_SPLIT_TOLERANCE of [helm]'s
    complex128 counts of this run; no kernel launches at 127^2.  Returns
    the split iterations by wavenumber."""
    from evostencils_tpu_torch.problems.helmholtz import helmholtz_2d_split

    reset(kernels)
    iterations = {}
    for k, want in helm_iterations.items():
        t0 = time.perf_counter()
        x, it, hist, _, _ = helm_solve(torch, helmholtz_2d_split(7, 3, k=k),
                                       device, torch.float64)
        wall = time.perf_counter() - t0
        log(f"[helm-split] k={k:g} float64 (re, im): {it} iterations to "
            f"{hist[it] / hist[0]:.3e} in {wall:.1f} s "
            f"({wall / max(it, 1) * 1e3:.2f} ms/iteration) on {card}; "
            f"[helm] complex128: {want}")
        check(all(xi.dtype == torch.float64 for xi in x) and len(x) == 2,
              "real float64 (re, im) fields")
        tol = HELM_SPLIT_TOLERANCE[k]
        check(hist[it] <= 1e-7 * hist[0] and abs(it - want) <= tol * want,
              f"k={k:g}: {it} split iterations, [helm]'s {want} "
              f"(tolerance {tol:.0%})")
        iterations[k] = it
    counts = counts_of(kernels)
    check(not any(counts.values()),
          f"kernels launched on [helm-split]: {counts}")
    return iterations


#: [main-fas]: chained FAS cycles per batch; a FAS V(2,2) cycle runs 200
#: Newton-Jacobi sweeps on its coarsest level, a few thousand launches
FAS_K_CYCLES = 50
#: the [main-fas] solves' relative nonlinear residual targets.  A float32
#: state holds the nonlinear residual of fas_2d_basic(10, 6) no lower
#: than about FAS_F32_FLOOR ||r0|| (the JAX package's CPU float32 solve
#: stalls between 1.007e-3 and 1.016e-3 for 95 cycles), so the float32
#: target sits tenfold above it; float64 reaches 1e-5
FAS_TARGETS = {"float32": 1e-2, "float64": 1e-5}
FAS_F32_FLOOR = 1e-3
#: the JAX package's CPU iterations of fas_v_cycle on fas_2d_basic(10, 6)
#: to FAS_TARGETS, by
#: ``JAX_PLATFORMS=cpu python -c 'from tests.test_torch_fas import
#: jax_fas_iterations as f; print(f(10, 6, "float32", 1e-2),
#: f(10, 6, "float64", 1e-5))'``
FAS_JAX_ITERATIONS = {"float32": 4, "float64": 18}


def fas_solve(torch, lowered, b, target, max_iterations=100):
    from evostencils_tpu_torch.compiler.solve import make_solver
    om = torch.tensor(lowered.default_omegas, dtype=b[0].dtype,
                      device=b[0].device)
    u0 = tuple(torch.zeros_like(x) for x in b)
    u, k, hist = make_solver(lowered, max_iterations, target)(u0, b, om)
    return u, k, hist[:k + 1].double().cpu().numpy()


def phase_main_fas(torch, kernels, device, card):
    """[main-fas]: the FAS cycle chained in batches, then its solves;
    returns the prolongation-correction kernel's launches over the
    batches."""
    from evostencils_tpu_torch.compiler.cycles import fas_v_cycle
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.compiler.solve import (make_cycle_loop,
                                                      residual_norm_fn)
    from evostencils_tpu_torch.problems.fas import fas_2d_basic
    from evostencils_tpu_torch.problems.poisson import build_rhs

    problem = fas_2d_basic(10, 6)

    def lowered_cycle(use_kernels=True):
        cycle = fas_v_cycle(problem.level_contexts, problem.rhs_entity,
                            coarse_operator=problem.coarsest_operator)
        return lower_cycle(cycle, problem.approximation, problem.rhs_entity,
                           use_kernels=use_kernels)

    lowered = lowered_cycle()
    b = build_rhs(problem, dtype=torch.float32, device=device)
    omegas = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                          device=device)
    u = tuple(torch.zeros_like(x) for x in b)
    loop = make_cycle_loop(lowered, FAS_K_CYCLES)
    n_dof = int(np.prod(problem.finest_grid[0].size))
    reset(kernels)
    batch_ms = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        u = loop(u, b, omegas)
        end.record()
        end.synchronize()
        batch_ms.append(start.elapsed_time(end))
    counts = {k: n for k, n in counts_of(kernels).items() if n}
    cycles = FAS_K_CYCLES * BATCHES
    gated = gated_levels(torch, problem.level_contexts)
    log(f"[main-fas] launches {counts} over {cycles} cycles, {gated} levels "
        "the prolongation-correction gate admits")
    check(counts == {"prolong_correct": gated * cycles} and gated == 3,
          f"[main-fas] launches {counts}: the prolongation-correction "
          f"kernel {gated} times a cycle and nothing else")
    steady = batch_ms[1:]
    ms_cycle = statistics.median(steady) / FAS_K_CYCLES
    MS_PER_CYCLE["main-fas"] = ms_cycle
    log(f"[main-fas] batches of {FAS_K_CYCLES} cycles: "
        + ", ".join(f"{t:.1f}" for t in batch_ms) + " ms (first warms up)")
    log(f"[main-fas] {n_dof} DoF: {ms_cycle:.4f} ms/cycle (median), "
        f"{min(steady) / FAS_K_CYCLES:.4f} (best), "
        f"{n_dof / (ms_cycle * 1e-3):.4e} DoF/s on {card}")
    exact = problem.exact_solution()[0]

    def error(x):
        return float(np.abs(x[0].double().cpu().numpy() - exact).max())

    res = float(residual_norm_fn(lowered.operator)(u, b))
    rel = res / float(torch.linalg.vector_norm(b[0].double()))
    log(f"[main-fas] after {cycles} cycles: relative nonlinear residual "
        f"{rel:.3e} (float32 floor near {FAS_F32_FLOOR:g} ||r0||), max "
        f"error against the analytic solution {error(u):.3e} (max|u| "
        f"{np.abs(exact).max():.3f})")
    check(u[0].dtype == torch.float32 and np.isfinite(rel) and rel <= 1e-2
          and error(u) <= 1e-2 * np.abs(exact).max(),
          "[main-fas] chained cycles")
    # float32: the kernels against the plain versions, and JAX's count
    target = FAS_TARGETS["float32"]
    runs = {}
    for use_kernels in (True, False):
        x, k, hist = fas_solve(torch, lowered_cycle(use_kernels), b, target)
        runs[use_kernels] = (k, hist)
        log(f"[main-fas solve] float32 {'kernels' if use_kernels else 'plain'}"
            f": {k} iterations to {target:g}, max error {error(x):.3e}, "
            f"history {np.array2string(hist / hist[0], precision=4)}")
    (k1, h1), (k0, h0) = runs[True], runs[False]
    want = FAS_JAX_ITERATIONS["float32"]
    check(k1 == k0 and abs(k1 - want) <= 1,
          f"[main-fas] float32: {k1} / {k0} iterations, JAX's {want}")
    floor = FAS_F32_FLOOR * h0[0]
    check(np.all(np.abs(h1 - h0) <= 1e-3 * h0 + floor),
          "[main-fas] float32 histories (rtol 1e-3 above the floor)")
    # float64: the gates take float32 only, so no kernel may run
    b64 = build_rhs(problem, dtype=torch.float64, device=device)
    target = FAS_TARGETS["float64"]
    reset(kernels)
    x, k, hist = fas_solve(torch, lowered, b64, target)
    want = FAS_JAX_ITERATIONS["float64"]
    log(f"[main-fas solve] float64: {k} iterations to {target:g} (JAX "
        f"CPU: {want}), max error against the analytic solution "
        f"{error(x):.3e}; launches {counts_of(kernels)}")
    check(abs(k - want) <= 1 and hist[k] <= target * hist[0],
          f"[main-fas] float64: {k} iterations, JAX's {want}")
    check(not any(counts_of(kernels).values()),
          f"[main-fas] float64 launched kernels: {counts_of(kernels)}")
    return {"prolong_correct": gated * cycles}


#: [evolve-fas]'s cuts: levels 6 -> 3 (63^2) for the CLI's default 10 ->
#: 6, and the budget of 300 cycles an evaluation cut to 50.  The
#: evaluator measures a float32 solve to 1e-5 and scores one that stops
#: above it infinite, but the float32 nonlinear residual floors near 1e-3
#: of its start at 1023^2 ([main-fas]): there every evaluation runs its
#: budget and scores infinite (an H100 run of the default levels took
#: 200.6 s, all 10 evaluations infinite); at 63^2 it reaches 1e-5.  A
#: cycle there costs 80-130 ms (200 coarse Newton-Jacobi sweeps), and
#: with the full budget the phase took 116.8 s, three candidates running
#: all 300 cycles; the two that converged took 8 each
EVOLVE_FAS_LEVELS = ("--max-level", "6", "--min-level", "3")
EVOLVE_FAS_MAX_ITERATIONS = 50
#: [evolve-split]'s cut, besides [evolve-helm]'s: the BiCGStab budget of
#: 10,000 iterations cut to 500 (the red-black V(2,1) takes 269 at k = 80
#: in float64, [helm]).  The split BiCGStab carries no NaN out of a
#: breakdown, so a candidate that does not converge runs its whole
#: budget; on an H100 the phase took 770.2 s with the full budget and
#: 51.1 s with 500.  Its seed is 18, not 0: none of seed 0's 10
#: candidates converges within 10,000 iterations in the JAX package on
#: the CPU in float32 either.  Of seeds 0-32, at 300 or 500 iterations,
#: only 4, 18 and 31 have a candidate that converges; seed 18's is its
#: seventh, of the initial population, at rho 0.9742 (JAX) and 0.9725
#: (port), about 440 iterations to the float32 target of 1e-5.  Seed 4's
#: converging candidate is an offspring, which depends on the parents'
#: float32 convergence factors, and on an H100 one run of it converged
#: and another did not.  By
#: ``tests.test_torch_split.evolve_evaluations`` on the CPU
EVOLVE_SPLIT_MAX_ITERATIONS = 500
EVOLVE_SPLIT_SEED = 18


def phase_evolve(torch, kernels, problem_name, tag, names=(),
                 timing_reps=None, options=(), max_iterations=None, seed=0):
    """``python -m evostencils_tpu_torch.optimize <problem_name> NSGAII
    --mu 2 --lambda 2 --generations 1 --seed <seed>`` in this process, at the
    problem's default levels, with ``options`` appended; at least one
    kernel of ``names`` must launch.  The evaluator's timing protocol takes
    ``timing_reps`` repetitions of its windows, or is off when that is
    None.  ``max_iterations`` cuts the problem's iteration budget (the
    solver's, BiCGStab's for Helmholtz).  Each batch of evaluations prints
    its iterations and its seconds.  The best individual, re-evaluated,
    must converge: reach the measurement target within the budget, at a
    convergence factor below 1."""
    from evostencils_tpu_torch import optimize
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.ir import transformations

    evaluated, finite = [], []
    population = CycleEvaluator.evaluate_population
    from_history = CycleEvaluator._result_from_history
    last = [0.0]

    def counted(self, individuals, pset):
        evaluated.append(len(individuals))
        last[0] = t = time.perf_counter()
        results = population(self, individuals, pset)
        finite.extend(np.isfinite(r.iterations) and r.iterations < 1e99
                      for r in results)
        log(f"[{tag}] {len(individuals)} evaluations in "
            f"{time.perf_counter() - t:.1f} s: iterations "
            f"{[float(r.iterations) for r in results]}")
        return results

    def logged(self, entry, hist, iters):
        # one line an evaluation: the solver's own iteration count and the
        # seconds since the last one ended (its lowering and timing too)
        result = from_history(self, entry, hist, iters)
        now = time.perf_counter()
        log(f"[{tag}] evaluation: {iters} solver iterations, "
            f"{now - last[0]:.1f} s")
        last[0] = now
        return result

    out_dir = ROOT / "evo_output" / "chip_smoke" / problem_name
    if "--levels-per-run" in options:
        out_dir = out_dir.with_name(problem_name + "-chunked")
    argv = [problem_name, "NSGAII", "--mu", str(EVOLVE_POPULATION),
            "--lambda", str(EVOLVE_POPULATION), "--generations", "1",
            "--seed", str(seed), *options,
            "--output", str(out_dir)]
    # a cut of this run's depth: the timing protocol, which solves each
    # structure again at least twice, takes one repetition of its windows
    # (the evaluator's default is 3) or is off (one solve an evaluation,
    # 1 ms an iteration)
    timing = CycleEvaluator.timing_enabled
    reps = CycleEvaluator.timing_reps
    if timing_reps is None:
        log(f"[{tag}] timing protocol off: one solve per evaluation")
    else:
        log(f"[{tag}] timing protocol cut to {timing_reps} repetition "
            f"per window size (default {reps})")
    get_problem = optimize.get_problem

    def budgeted(*args, **kw):
        problem = get_problem(*args, **kw)
        if max_iterations is not None:
            problem.max_iterations = max_iterations
        return problem
    if max_iterations is not None:
        log(f"[{tag}] iteration budget cut to {max_iterations}")
    reset(kernels)
    CycleEvaluator.evaluate_population = counted
    CycleEvaluator._result_from_history = logged
    CycleEvaluator.timing_enabled = timing_reps is not None
    CycleEvaluator.timing_reps = timing_reps or reps
    optimize.get_problem = budgeted
    t0 = time.perf_counter()
    try:
        result = optimize.main(argv)
    finally:
        CycleEvaluator.evaluate_population = population
        CycleEvaluator._result_from_history = from_history
        CycleEvaluator.timing_enabled = timing
        CycleEvaluator.timing_reps = reps
        optimize.get_problem = get_problem
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_of(kernels)
    log(f"[{tag}] {' '.join(argv[:-2])}: {sum(evaluated)} evaluations in "
        f"{len(evaluated)} batches, {wall:.1f} s wall; launches {counts}")
    if names:
        check(any(counts[name] for name in names),
              f"none of {names} launched on the {tag} path")

    def level(flag):
        return int(options[options.index(flag) + 1]) if flag in options \
            else None
    problem = budgeted(problem_name, level("--max-level"),
                       level("--min-level"))
    evaluator = CycleEvaluator(problem, dtype=np.float32, device="cuda")
    evaluator.timing_enabled = False
    levels_per_run = level("--levels-per-run")
    if levels_per_run is not None:
        # a level-chunked run: its chunks' best strings (finest first)
        # rebuild the composed program, measured on the finest grid
        from evostencils_tpu_torch.optimization.program import Optimizer
        chunks = result["chunk_grammar_strings"]
        check(len(chunks) == len(range(0, problem.max_level
                                       - problem.min_level, levels_per_run))
              and chunks[-1] == result["grammar_string"],
              f"[{tag}] one best string a chunk")
        expr, res = Optimizer(problem, evaluator=evaluator) \
            .evaluate_chunked_program(chunks, levels_per_run=levels_per_run)
        what = f"{len(chunks)} chunks"
    else:
        pset = generate_primitive_set(
            problem.approximation, problem.rhs_entity,
            problem.level_contexts, problem.coarsest_operator,
            FAS=problem.nonlinear_term is not None,
            coupled_fields=problem.coupled_fields)[0]
        best = result["grammar_string"]
        individual = gp.parse_tree(best, pset)
        check(str(individual) == best, "the best individual re-parses")
        expr = gp.compile_tree(individual, pset)[0]
        transformations.assign_cycle_ids(expr)
        res = evaluator.evaluate_expression(expr)
        what = f"{len(individual)} nodes"
    log(f"[{tag}] best individual ({what}) re-evaluated: "
        f"rho {res.convergence_factor:.5f}, {res.iterations:.0f} iterations; "
        f"{sum(finite)} of {len(finite)} evaluations of the run converged")
    check(np.isfinite(res.iterations) and res.iterations < evaluator.infinity
          and res.convergence_factor < 1, "the best individual converges")
    return out_dir


#: [deep] / [deep-bf16]: the deep solves' 2D Poisson hierarchy, levels
#: 10 -> 4 (1023^2 down to a dense 15^2 solve), as scripts/deep_solve.py
#: builds it at its default level (poisson_2d(10, max(10 - 6, 2)))
DEEP_LEVEL = 10
#: [deep-fas]: fas_2d_basic(10, 6), the FAS deep solve at the BASELINE
#: FAS row's 1023^2 (scripts/deep_solve.py defaults to 8 -> 4)
DEEP_FAS_LEVELS = (10, 6)
#: the deep solves' kernel-against-plain rule: histories within 1e-3
#: relative above 1e-10 of their first entry, each entry also allowed
#: DEEP_F32_FLOOR of the one before it.  An outer step's residual carries
#: the float32 rounding of its correction, a fixed share of the residual
#: it corrects (4.5e-7 at 63^2 on the CPU, tests/test_torch_refine.py;
#: larger on finer grids), which the kernels and the plain versions round
#: apart, as the last entry of a float32 solve sits on its floor
#: (phase_solve).  In [deep] the only entry above 1e-10 besides the first
#: is the first correction's (2.670e-6 relative with the kernels, 1.851e-6
#: with the plain versions on an H100), so there the rule holds equal
#: outer counts and little else; [kernels] holds rows 1-2 themselves
DEEP_HIST_RTOL, DEEP_HIST_FLOOR, DEEP_F32_FLOOR = 1e-3, 1e-10, 1e-5
#: [deep-split]: the wavenumbers of the reliable float32 solve (k = 160,
#: 2,651 iterations and 23.7 s on an H100, and k = 320 wait for a graphed
#: loop: at thousands of iterations and about 10 ms an iteration they
#: would take the script's time margin) and of the float64-basis one,
#: and the JAX tests' bounds: the true residual recomputed in float64,
#: the float64-basis iterations against [helm-split]'s float64 count
#: (tests/test_refine_split.py:96-107)
DEEP_SPLIT_KS, DEEP_SPLIT_F64_BASIS_K = (80.0,), 80.0
DEEP_SPLIT_TRUE_TOL, DEEP_SPLIT_FACTOR, DEEP_SPLIT_SLACK = 2e-7, 1.15, 10
#: the reliable float32 solve's iterations are rounding-bound: the JAX
#: package's CPU count of the same solve
#: (``tests.test_torch_refine_split.jax_reliable_iterations``) is 296 at
#: k = 80, 1.10 times the float64 count (269), and the port's took 333,
#: 334 and 349 on the CPU with 1, 2 and 4 torch threads and 367 on an
#: H100; so it is held to DEEP_SPLIT_JAX_FACTOR times the JAX package's
#: count, as tests/test_torch_refine_split.py holds it on the CPU, and
#: the float64-basis solve, whose recurrence is float64, to the float64
#: count's bound
DEEP_SPLIT_JAX_ITERATIONS = {80.0: 296}
DEEP_SPLIT_JAX_FACTOR = 1.3
#: [deep-bf16]: the JAX package's outer steps of the same bf16 solve on
#: the CPU (``tests.test_torch_refine.jax_deep_outer(10)``: 11, with
#: ratios 0.111, 0.046, 1.013, 0.003, 2.305, 0.003, 0.242, 0.005, 0.245,
#: 0.003; the TPU record, BASELINE.md:348, 11 too).  At 1023^2 a bf16
#: correction's rounding stalls every other outer step in both packages,
#: so the phase holds the port to this count (within 1) and each two
#: consecutive outer steps to a contraction below DEEP_BF16_PAIR_RATIO
#: (the JAX ratios' pairs reach 0.047 at most); the CPU tests hold every
#: single ratio below 0.2 at 63^2 and 255^2, where both packages keep it
#: (tests/test_torch_refine.py)
DEEP_BF16_JAX_OUTER, DEEP_BF16_PAIR_RATIO = 11, 0.2
#: the rows-1-2 leg names the deep solves launch, float32 and bf16
DEEP_LEGS = ("presmooth_residual_restrict", "prolong_correct_postsmooth_col")


def gated_levels(torch, contexts):
    """The levels of ``contexts`` that the 2D legs' gate admits."""
    from evostencils_tpu_torch.ops.kernels import transfer
    return sum(1 for ctx in contexts if transfer.supports(torch.empty(
        ctx.grid[0].size, device="meta", dtype=torch.float32)))


def deep_run(torch, kernels, solve, b, card, tag, cycles_per_outer):
    """One refined solve with the counts set to 0 just before: (result,
    launches, inner cycles); logs the outer count, the relative history,
    the wall seconds and ms per inner cycle."""
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in counts_of(kernels).items() if n}
    cycles = cycles_per_outer * (res.outer_iterations - (
        1 if res.converged else 0))
    rel = np.asarray(res.residuals) / res.residuals[0]
    log(f"[{tag}] converged={res.converged}, {res.outer_iterations} outer "
        f"steps, {cycles} inner cycles, {wall:.2f} s "
        f"({wall / max(cycles, 1) * 1e3:.2f} ms an inner cycle, the float64 "
        f"residuals with them) on {card}; relative history "
        f"{np.array2string(rel, precision=4)}; launches {counts}")
    return res, counts, cycles


def deep_histories(tag, h1, h0):
    """DEEP_HIST_RTOL above DEEP_HIST_FLOOR of the first entry, each entry
    allowed DEEP_F32_FLOOR of the one before (the float32 rounding of the
    correction between them)."""
    h1, h0 = (np.asarray(h) / h[0] for h in (h1, h0))
    n = min(len(h1), len(h0))
    above = np.minimum(h1[:n], h0[:n]) > DEEP_HIST_FLOOR
    rel = np.abs(h1[:n] - h0[:n]) / h0[:n]
    prev = np.concatenate([[0.0], h0[:n - 1]])
    log(f"[{tag}] kernels against plain: histories agree to "
        f"{rel[above].max():.3e} relative above {DEEP_HIST_FLOOR:g}, "
        f"{rel[1:n].max() if n > 1 else 0.0:.3e} overall")
    check(np.all((np.abs(h1[:n] - h0[:n]) <= DEEP_HIST_RTOL * h0[:n]
                  + DEEP_F32_FLOOR * prev)[above]),
          f"[{tag}] histories (rtol {DEEP_HIST_RTOL} above "
          f"{DEEP_HIST_FLOOR:g}, {DEEP_F32_FLOOR:g} of the entry before)")


def phase_deep(torch, kernels, device, card, bf16=False):
    """[deep] (float32 inner cycles, ``bf16`` false) or [deep-bf16]: the
    2D Poisson deep solve of scripts/deep_solve.py on the card,
    poisson_2d(10, 4) with the red-black V(2,1) at omega 1.15 to 1e-12,
    once with the kernels and once with the plain versions.  [deep]: 8
    cycles an outer step; equal outer counts, histories by
    deep_histories.  [deep-bf16]: 3 bf16 cycles an outer step, at most 16
    outer steps; outer counts within 1 of each other and of the JAX
    package's (DEEP_BF16_JAX_OUTER), the contraction over each two
    consecutive outer steps below DEEP_BF16_PAIR_RATIO, every ratio
    logged.  Rows 1-2 (their bf16
    forms in
    [deep-bf16]) must run once per gated level and inner cycle, and no
    other kernel.  Returns their launches in the kernel run."""
    from evostencils_tpu_torch import deep_solve
    from evostencils_tpu_torch.compiler.refine import make_refined_solver
    from evostencils_tpu_torch.problems.poisson import build_rhs

    tag = "deep-bf16" if bf16 else "deep"
    options = dict(inner_cycles=3, max_outer=16,
                   inner_dtype=torch.bfloat16) if bf16 else \
        dict(inner_cycles=8)
    suffix = "_bf16" if bf16 else ""
    runs = {}
    for use_kernels in (True, False):
        problem, lowered = deep_solve.poisson_lowered(DEEP_LEVEL,
                                                      use_kernels)
        b = build_rhs(problem, dtype=torch.float32, device=device)[0]
        solve = make_refined_solver(lowered, target_reduction=1e-12,
                                    **options)
        res, counts, cycles = deep_run(
            torch, kernels, solve, b, card,
            f"{tag} {'kernels' if use_kernels else 'plain'}",
            options["inner_cycles"])
        check(res.converged and res.residuals[-1] <= 1e-12 * res.residuals[0]
              and res.solution.dtype == torch.float64
              and torch.isfinite(res.solution).all(),
              f"[{tag}] converged to 1e-12 (kernels {use_kernels})")
        runs[use_kernels] = (res, counts, cycles)
    (r1, c1, n1), (r0, c0, _) = runs[True], runs[False]
    gated = gated_levels(torch, problem.level_contexts)
    want = {name + suffix: gated * n1 for name in DEEP_LEGS}
    check(c1 == want and gated == 3 and not c0,
          f"[{tag}] launches {c1} (plain run {c0}), expected {want}")
    if bf16:
        h = r1.residuals
        ratios = np.asarray([y / x for x, y in zip(h, h[1:])])
        pairs = ratios[1:] * ratios[:-1]
        log(f"[{tag}] outer ratios {np.array2string(ratios, precision=3)}, "
            f"over two steps {np.array2string(pairs, precision=4)}; plain "
            f"versions: {r0.outer_iterations} outer steps; the JAX "
            f"package's CPU: {DEEP_BF16_JAX_OUTER}")
        check(len(pairs) and pairs.max() < DEEP_BF16_PAIR_RATIO
              and abs(r1.outer_iterations - r0.outer_iterations) <= 1
              and abs(r1.outer_iterations - DEEP_BF16_JAX_OUTER) <= 1,
              f"[{tag}] two-step ratios {pairs}, outer counts "
              f"{r1.outer_iterations} / {r0.outer_iterations} / JAX "
              f"{DEEP_BF16_JAX_OUTER} within 1")
    else:
        check(r1.outer_iterations == r0.outer_iterations,
              f"[{tag}] outer counts {r1.outer_iterations} / "
              f"{r0.outer_iterations}")
        deep_histories(tag, r1.residuals, r0.residuals)
    return c1


def phase_deep_fas(torch, kernels, device, card):
    """[deep-fas]: fas_2d_basic(10, 6) to 1e-10 by Newton steps of 3
    Richardson iterations, each preconditioned by 3 float32 cycles of the
    shifted linear operator L + 20 I, at most 10 outer steps
    (scripts/deep_solve.py:95-117), once with the kernels and once with
    the plain versions: both converge with equal outer counts and
    histories by deep_histories; the shifted cycle's legs (rows 1-2) run
    once per gated level and cycle, and no other kernel.  Returns their
    launches."""
    from evostencils_tpu_torch import deep_solve
    from evostencils_tpu_torch.compiler.refine import make_refined_solver
    from evostencils_tpu_torch.problems.poisson import build_rhs

    runs = {}
    for use_kernels in (True, False):
        fas, flow, corr = deep_solve.fas_lowered(*DEEP_FAS_LEVELS,
                                                 use_kernels=use_kernels)
        b = build_rhs(fas, dtype=torch.float32, device=device)[0]
        solve = make_refined_solver(
            flow, inner_cycles=3, max_outer=10, target_reduction=1e-10,
            richardson_iterations=3,
            nonlinear=fas.level_contexts[0].operator, correction_lowered=corr)
        res, counts, cycles = deep_run(
            torch, kernels, solve, b, card,
            f"deep-fas {'kernels' if use_kernels else 'plain'}", 3 * 3)
        err = float(np.abs(res.solution.cpu().numpy()
                           - fas.exact_solution()[0]).max())
        log(f"[deep-fas] max error against the analytic solution {err:.3e} "
            "(the discretization error)")
        check(res.converged and res.residuals[-1] <= 1e-10 * res.residuals[0]
              and err <= 1e-3, f"[deep-fas] converged to 1e-10 (kernels "
              f"{use_kernels})")
        runs[use_kernels] = (res, counts, cycles)
    (r1, c1, n1), (r0, c0, _) = runs[True], runs[False]
    gated = gated_levels(torch, fas.level_contexts)
    want = {name: gated * n1 for name in DEEP_LEGS}
    check(c1 == want and gated == 3 and not c0,
          f"[deep-fas] launches {c1} (plain run {c0}), expected {want}")
    check(r1.outer_iterations == r0.outer_iterations,
          f"[deep-fas] outer counts {r1.outer_iterations} / "
          f"{r0.outer_iterations}")
    deep_histories("deep-fas", r1.residuals, r0.residuals)
    return c1


def phase_deep_split(torch, kernels, device, card, split_iterations):
    """[deep-split]: helmholtz_2d_split(7, 3) in float32 to a TRUE
    relative residual of 1e-7 by ``reliable_bicgstab_split`` at
    DEEP_SPLIT_KS, and by ``f64_basis_bicgstab_split`` at
    DEEP_SPLIT_F64_BASIS_K, one red-black V(2,1) (omega 0.6) a
    preconditioner application replayed from a CUDA graph: the residual
    recomputed in float64 from the returned solution at most
    DEEP_SPLIT_TRUE_TOL; the reliable solve's iterations at most
    DEEP_SPLIT_JAX_FACTOR times the JAX package's CPU count, the
    float64-basis solve's at most DEEP_SPLIT_FACTOR times [helm-split]'s
    float64 count + DEEP_SPLIT_SLACK; no kernel launches at 127^2."""
    from evostencils_tpu_torch.compiler import refine_split
    from evostencils_tpu_torch.compiler.lower import (lower_cycle,
                                                      operator_applier)
    from evostencils_tpu_torch.compiler.solve import make_preconditioner
    from evostencils_tpu_torch.problems.helmholtz import helmholtz_2d_split
    from evostencils_tpu_torch.problems.poisson import build_rhs

    reset(kernels)
    cases = [("reliable", k) for k in DEEP_SPLIT_KS] + \
        [("f64-basis", DEEP_SPLIT_F64_BASIS_K)]
    results = []
    for solver, k in cases:
        problem = helmholtz_2d_split(7, 3, k=k)
        op = problem.outer_solver.operator
        lowered = lower_cycle(helm_cycle(problem), problem.approximation,
                              problem.rhs_entity)
        b = build_rhs(problem, dtype=torch.float32, device=device)
        om = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                          device=device)
        precond = make_preconditioner(lowered, om, b)
        residual = refine_split.split_system_residual_f64(op)
        maxiter = problem.outer_solver.max_iterations
        t0 = time.perf_counter()
        if solver == "reliable":
            x, it, hist = refine_split.reliable_bicgstab_split(
                operator_applier(op), precond, residual, b, tol=1e-7,
                maxiter=maxiter)
        else:
            x, it, hist = refine_split.f64_basis_bicgstab_split(
                refine_split.split_system_matvec_f64(op), precond, residual,
                b, tol=1e-7, maxiter=maxiter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b64 = build_rhs(problem, dtype=torch.float64, device=device)
        ax = operator_applier(op)(x)
        true = float(torch.sqrt(sum(torch.sum((bi - ai) ** 2)
                                    for bi, ai in zip(b64, ax)))
                     / torch.sqrt(sum(torch.sum(bi ** 2) for bi in b64)))
        want = split_iterations[k]
        if solver == "reliable":
            jax_count = DEEP_SPLIT_JAX_ITERATIONS[k]
            bound = DEEP_SPLIT_JAX_FACTOR * jax_count
            against = f"the JAX package's CPU float32: {jax_count}"
        else:
            bound = DEEP_SPLIT_FACTOR * want + DEEP_SPLIT_SLACK
            against = "the float64 count's"
        log(f"[deep-split] {solver} k={k:g} float32: {it} iterations "
            f"({len(hist)} replacements) in {wall:.1f} s "
            f"({wall / max(it, 1) * 1e3:.2f} ms/iteration) on {card}; true "
            f"relative residual {true:.3e} (float64, from the solution), "
            f"last replacement {hist[-1]:.3e}; [helm-split] float64: "
            f"{want}; {against} (bound {bound:.0f})")
        results.append((all(xi.dtype == torch.float64 for xi in x)
                        and true <= DEEP_SPLIT_TRUE_TOL and hist[-1] <= 1e-7
                        and 0 < it <= bound,
                        f"[deep-split] {solver} k={k:g}: {it} iterations "
                        f"(bound {bound:.0f}), true residual {true:.3e}"))
    for ok, msg in results:
        check(ok, msg)
    counts = counts_of(kernels)
    check(not any(counts.values()),
          f"kernels launched on [deep-split]: {counts}")


#: [chunked] / [cg]: 2D Poisson at 1023^2, levels 10 -> 5 (the [evaluator]
#: hierarchy), the reference RB V(2,1) at omega 1.15, whole and split as a
#: level-chunked run with --levels-per-run 3 splits it: chunk 0 on 1023^2,
#: 511^2 and 255^2 over the 127^2 boundary, chunk 1 on 127^2 and 63^2 over
#: the dense 31^2 solve
CHUNKED_LEVELS, CHUNKED_LEVELS_PER_RUN = (10, 5), 3
#: chained cycles of each program ([chunked]) and the relative agreement of
#: their residual histories: the composed program is the whole cycle's
#: arithmetic, so the same kernels and torch operations in the same order
CHUNKED_CYCLES, CHUNKED_HIST_RTOL = 20, 1e-6
#: the timed batches' order, so that a drift of the host hits both
CHUNKED_TURNS = ("whole", "composed", "composed", "whole", "whole",
                 "composed")
#: [cg]: chunk 0 of --levels-per-run 2 on 10 -> 5, 1023^2 and 511^2 over a
#: CG solve of 255^2 (65,025 unknowns, above DIRECT_SOLVE_MAX), and its
#: chained cycles timed; the fixed CG coarse solve of tests/test_krylov.py:
#: 99-131 at 1023^2 (300 iterations on the 31^2 level)
CG_LEVELS_PER_RUN, CG_TIMED_CYCLES, CG_KRYLOV_ITERATIONS = 2, 2, 300
#: [evolve-chunked]: the CLI's chunked run (scripts/optimize.py
#: --levels-per-run), levels 8 -> 4 in chunks of 2: 255^2 and 127^2 over the
#: dense 63^2 boundary (3,969 unknowns), then 63^2 and 31^2 over 15^2
EVOLVE_CHUNKED_OPTIONS = ("--levels-per-run", "2", "--max-level", "8",
                          "--min-level", "4")


def chunk_split(problem, levels_per_run, omega=1.15):
    """(chain, (candidate, approximation, rhs)) of the RB V(2,1) on
    ``problem`` split into chunks of ``levels_per_run`` levels, each chunk
    over the entities the optimizer gives it
    (``optimization.program._chunk_entities``)."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.compiler.lower import ChainLink
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.optimization import program

    contexts = problem.level_contexts
    links = []
    for ci, i in enumerate(range(0, len(contexts), levels_per_run)):
        ctxs = contexts[i:i + levels_per_run]
        _, rhs = program._chunk_entities(problem, ctxs, ci == 0)
        cycle = v_cycle(ctxs, rhs, pre_smoothing=2, post_smoothing=1,
                        omega=omega, partitioning=part.RedBlack,
                        coarse_operator=program._chunk_coarsest(
                            problem, contexts, i, levels_per_run))
        # v_cycle starts from the chunk's finest approximation, the
        # problem's own in chunk 0
        links.append(ChainLink(cycle, ctxs[0].approximation, rhs))
    return links[:-1], (links[-1].root, links[-1].approximation,
                        links[-1].rhs)


def chained_cycles(torch, kernels, lowered, b, n_cycles):
    """``n_cycles`` chained steps from zero with the counts set to 0 just
    before: (launches, the residual after each cycle relative to ||b||)."""
    from evostencils_tpu_torch.compiler.solve import residual_norm_fn
    res_norm = residual_norm_fn(lowered.operator)
    om = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                      device=b[0].device)
    u = tuple(torch.zeros_like(x) for x in b)
    hist = []
    reset(kernels)
    for _ in range(n_cycles):
        u = lowered.step(u, b, om)
        hist.append(res_norm(u, b))
    counts = {k: n for k, n in counts_of(kernels).items() if n}
    bnorm = float(torch.linalg.vector_norm(b[0].double()))
    return counts, torch.stack(hist).double().cpu().numpy() / bnorm


def cycle_ms(torch, lowered, b, n_cycles, u=None):
    """(ms a cycle, by CUDA events, of ``n_cycles`` chained steps from
    ``u`` or zero; the last state)."""
    om = torch.tensor(lowered.default_omegas, dtype=torch.float32,
                      device=b[0].device)
    u = u or tuple(torch.zeros_like(x) for x in b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_cycles):
        u = lowered.step(u, b, om)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_cycles, u


def phase_chunked(torch, kernels, device, card):
    """[chunked]: the composed program of a level-chunked run against the
    whole cycle it splits, on the card: equal launches per kernel, residual
    histories within CHUNKED_HIST_RTOL over CHUNKED_CYCLES chained cycles,
    the composed program's kernels against their plain versions (solves
    to 1e-5, as phase_solve); ms a cycle of each.  Returns the composed
    program's launches over one batch."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.compiler.lower import (lower_composed,
                                                      lower_cycle)
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.problems.poisson import build_rhs, poisson_2d

    problem = poisson_2d(*CHUNKED_LEVELS)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    whole = lower_cycle(v_cycle(
        problem.level_contexts, problem.rhs_entity, pre_smoothing=2,
        post_smoothing=1, omega=1.15, partitioning=part.RedBlack,
        coarse_operator=problem.coarsest_operator), problem.approximation,
        problem.rhs_entity)
    chain, cand = chunk_split(problem, CHUNKED_LEVELS_PER_RUN)
    sizes = [[tuple(ctx.grid[0].size)[0] for ctx in problem.level_contexts[
        i:i + CHUNKED_LEVELS_PER_RUN]] for i in range(
        0, len(problem.level_contexts), CHUNKED_LEVELS_PER_RUN)]
    log(f"[chunked] poisson_2d{CHUNKED_LEVELS} RB V(2,1) in chunks of "
        f"{CHUNKED_LEVELS_PER_RUN} levels: {sizes} over the dense "
        f"{tuple(problem.coarsest_operator.grid[0].size)[0]}^2 solve")
    composed = lower_composed(chain, *cand)
    check(composed.cgs_override is not None and not composed.syncs_host,
          "[chunked] the composed program splices its coarser chunk")
    programs = {"whole": whole, "composed": composed}
    out = {}
    for name, lowered in programs.items():
        out[name] = chained_cycles(torch, kernels, lowered, b,
                                   CHUNKED_CYCLES)
        counts, hist = out[name]
        log(f"[chunked] {name}: launches {counts} over {CHUNKED_CYCLES} "
            f"cycles; relative residuals "
            f"{np.array2string(hist[::4], precision=3)} (every 4th)")
    # timed batches in turns, whole and composed alternating
    ms = {name: [] for name in programs}
    state = {name: None for name in programs}
    for name in CHUNKED_TURNS:
        t, state[name] = cycle_ms(torch, programs[name], b, CHUNKED_CYCLES,
                                  state[name])
        ms[name].append(t)
    log("[chunked] ms a cycle (median of " + str(len(ms["whole"]))
        + f" batches of {CHUNKED_CYCLES} in turns {CHUNKED_TURNS}) on "
        f"{card}: " + ", ".join(
            f"{name} {statistics.median(v):.4f} ("
            + " / ".join(f"{x:.4f}" for x in v) + ")"
            for name, v in ms.items()))
    (cw, hw), (cc, hc) = out["whole"], out["composed"]
    gated = gated_levels(torch, problem.level_contexts)
    check(cc == cw and cc.get("presmooth_residual_restrict") == gated
          * CHUNKED_CYCLES,
          f"[chunked] the composed program launches {cc}, the whole cycle "
          f"{cw}")
    rel = np.abs(hc - hw) / hw
    log(f"[chunked] residual histories agree to {rel.max():.3e} relative "
        f"(largest difference over {CHUNKED_CYCLES} cycles)")
    check(np.all(np.isfinite(hc)) and rel.max() <= CHUNKED_HIST_RTOL,
          f"[chunked] histories within {CHUNKED_HIST_RTOL}")
    compare_solves(torch, "chunked", b, 20,
                   lambda use_kernels: lower_composed(
                       chain, *cand, use_kernels=use_kernels))
    return cc


def phase_cg(torch, kernels, device, card):
    """[cg]: chunk 0 of a --levels-per-run 2 run on 10 -> 5 alone, its
    coarse solve CG on 255^2: its cycles to 1e-5 with the kernels and the
    plain versions (as phase_solve), CG iterations and host syncs a coarse
    solve, ms a cycle; then the V(2,1) with a fixed 300-iteration CG coarse
    solve (``v_cycle(coarse_krylov="CG")``) at 1023^2 against the dense
    coarse solve's cycle (tests/test_krylov.py:99-131): at most one cycle
    more to 1e-5.  Returns the launches of chunk 0's timed cycles."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.compiler.lower import (CG_MAXITER,
                                                      CG_TOLERANCE,
                                                      lower_cycle,
                                                      operator_applier)
    from evostencils_tpu_torch.config import DIRECT_SOLVE_MAX
    from evostencils_tpu_torch.ir import base, transformations
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.ops import solvers
    from evostencils_tpu_torch.problems.poisson import build_rhs, poisson_2d

    problem = poisson_2d(*CHUNKED_LEVELS)
    b = build_rhs(problem, dtype=torch.float32, device=device)
    link = chunk_split(problem, CG_LEVELS_PER_RUN)[0][0]

    def lower(use_kernels=True):
        return lower_cycle(link.root, link.approximation, link.rhs,
                           use_kernels=use_kernels)
    lowered = lower()
    (cgs,) = transformations.find_nodes(link.root, base.CoarseGridSolver)
    n = int(np.prod(cgs.operator.grid[0].size))
    sizes = "^2, ".join(str(ctx.grid[0].size[0]) for ctx in
                        problem.level_contexts[:CG_LEVELS_PER_RUN])
    log(f"[cg] chunk 0 alone: {sizes}^2 over a CG solve of {n} "
        f"unknowns (tol {CG_TOLERANCE:g}, at most {CG_MAXITER} iterations, "
        f"the test read every {solvers.CG_CHECK_EVERY})")
    check(lowered.syncs_host and n > DIRECT_SOLVE_MAX,
          "[cg] the coarse solve is CG")
    solvers.reset_cg_counts()
    compare_solves(torch, "cg", b, 20, lower)
    counts = dict(solvers.cg_counts)
    solves = counts["solves"]
    log(f"[cg] {solves} CG coarse solves over both solves: "
        f"{int(counts['iterations']) / solves:.1f} iterations and "
        f"{counts['syncs'] / solves:.1f} host syncs a coarse solve")
    check(solves > 0 and int(counts["iterations"]) > 0, "[cg] CG ran")
    # one coarse solve alone, on a right-hand side from a seed
    rc = torch.tensor(np.random.default_rng(0).standard_normal(
        tuple(cgs.operator.grid[0].size)), dtype=torch.float32,
        device=device)
    matvec = operator_applier(cgs.operator)
    for timed in (False, True):
        solvers.reset_cg_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers.cg(matvec, (rc,), tol=CG_TOLERANCE, maxiter=CG_MAXITER)
        torch.cuda.synchronize()
    log(f"[cg] one CG solve of {n} unknowns from a seeded rhs: "
        f"{int(solvers.cg_counts['iterations'])} iterations, "
        f"{solvers.cg_counts['syncs']} host syncs, "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host clock, after one "
        f"warm-up solve) on {card}")
    launches, _ = chained_cycles(torch, kernels, lowered, b,
                                 CG_TIMED_CYCLES)
    solvers.reset_cg_counts()
    ms, _ = cycle_ms(torch, lowered, b, CG_TIMED_CYCLES)
    log(f"[cg] chunk 0: {ms:.4f} ms a cycle ({CG_TIMED_CYCLES} chained "
        f"cycles after as many counted ones, each with its CG coarse solve: "
        f"{int(solvers.cg_counts['iterations']) / CG_TIMED_CYCLES:.1f} "
        f"iterations, {solvers.cg_counts['syncs'] / CG_TIMED_CYCLES:.1f} "
        f"host syncs) on {card}; launches {launches}")
    check(launches.get("presmooth_residual_restrict") == CG_TIMED_CYCLES
          * gated_levels(torch, problem.level_contexts[:CG_LEVELS_PER_RUN]),
          "[cg] rows 1-2 on each gated level of chunk 0 each cycle")
    iterations = {}
    for krylov in (None, "CG"):
        cycle = v_cycle(problem.level_contexts, problem.rhs_entity,
                        pre_smoothing=2, post_smoothing=1, omega=1.15,
                        partitioning=part.RedBlack,
                        coarse_operator=problem.coarsest_operator,
                        coarse_krylov=krylov,
                        coarse_krylov_iterations=CG_KRYLOV_ITERATIONS)
        low = lower_cycle(cycle, problem.approximation, problem.rhs_entity)
        k, hist = solve_history(torch, low, b, 20, 1e-5)
        iterations[krylov] = k
        ms, _ = cycle_ms(torch, low, b, CG_TIMED_CYCLES)
        log(f"[cg] V(2,1) coarse {krylov or 'dense'}: {k} cycles to 1e-5, "
            f"history {np.array2string(hist / hist[0], precision=3)}; "
            f"{ms:.4f} ms a cycle ({CG_TIMED_CYCLES} chained after the "
            f"solve) on {card}")
    check(0 < iterations["CG"] <= iterations[None] + 1,
          f"[cg] the fixed CG coarse solve's cycles {iterations}")
    return launches


def phase_evolve_chunked(torch, kernels, device, card):
    """[evolve-chunked]: ``poisson2d NSGAII --mu 2 --lambda 2 --generations
    1 --seed 0 --levels-per-run 2 --max-level 8 --min-level 4`` through
    phase_evolve (timing protocol off), whose best composed program must
    converge; then the evaluate_evolved_solver twin on its
    best_grammar.txt, in float32 with the timing protocol at one
    repetition."""
    from evostencils_tpu_torch import evaluate_evolved_solver
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator

    out_dir = phase_evolve(torch, kernels, "poisson2d", "evolve-chunked",
                           STANDALONE + DEEP_LEGS, None,
                           EVOLVE_CHUNKED_OPTIONS)
    grammar = out_dir / "best_grammar.txt"
    lines = grammar.read_text().split()
    check(len(lines) == 2, f"[evolve-chunked] {len(lines)} chunk strings")
    reps = CycleEvaluator.timing_reps
    CycleEvaluator.timing_reps = EVOLVE_TIMING_REPS
    t0 = time.perf_counter()
    try:
        res = evaluate_evolved_solver.main(
            [str(grammar), "poisson2d", *EVOLVE_CHUNKED_OPTIONS[2:],
             "--levels-per-run", EVOLVE_CHUNKED_OPTIONS[1], "--f32"])
    finally:
        CycleEvaluator.timing_reps = reps
    log(f"[evolve-chunked] evaluate_evolved_solver on {grammar.name}: "
        f"{res.iterations:.0f} iterations, rho {res.convergence_factor:.5f}, "
        f"{res.time_to_convergence_ms:.3f} ms to convergence, "
        f"{time.perf_counter() - t0:.1f} s (timing protocol at "
        f"{EVOLVE_TIMING_REPS} repetition) on {card}")
    check(np.isfinite(res.iterations) and res.iterations < 1e99
          and res.convergence_factor < 1,
          "[evolve-chunked] the twin's composed program converges")


#: [lfa]: the LFA cases on the card, each with the exact rho the JAX
#: package's numpy backend gives for the same cycle (8 samples a frequency
#: axis): name -> (problem, max level, min level, partitioning, omega,
#: rho).  The values were made with
#: ``env JAX_PLATFORMS=cpu python -c 'import jax;
#: jax.config.update("jax_enable_x64", True); from
#: evostencils_tpu.compiler.cycles import v_cycle; from evostencils_tpu.ir
#: import partitioning as part; from evostencils_tpu.problems import
#: poisson, elasticity; from evostencils_tpu.prediction.convergence import
#: ConvergenceEvaluator; p = poisson.poisson_2d(max_level=9, min_level=5);
#: c = v_cycle(p.level_contexts, p.rhs_entity, pre_smoothing=2,
#: post_smoothing=1, omega=1.15, partitioning=part.RedBlack,
#: coarse_operator=p.coarsest_operator);
#: print(repr(ConvergenceEvaluator(2, samples_per_axis=8,
#: backend="numpy").compute_spectral_radius(c)))'``, and the same with
#: each case's problem, levels, partitioning and omega
LFA_CASES = {
    "poisson-rb-v21": ("poisson_2d", 9, 5, "RedBlack", 1.15,
                       0.0297139954431784),
    "poisson-jacobi-v21": ("poisson_2d", 9, 5, "Single", 0.8,
                           0.24002211793874612),
    "elasticity-rb-v21": ("linear_elasticity_2d", 8, 4, "RedBlack", 1.25,
                          0.16113275292305668),
}
#: [lfa]: exact rho against the stored value (absolute), and the power
#: method against exact (relative), the accuracy the engine claims for it
LFA_EXACT_TOL = 1e-9
LFA_POWER_RTOL = 1e-3
#: [lfa]: timed spectral radii of the power method, after one warm-up;
#: exact eigenvalues (1-5 s a rho, on the host) are timed on their one run,
#: for the three model-based phases' 60 s
LFA_REPS = 3


def lfa_cycle(build, max_level, min_level, partitioning, omega):
    """The port's V(2,1) of an [lfa] case."""
    from evostencils_tpu_torch.compiler.cycles import v_cycle
    from evostencils_tpu_torch.ir import partitioning as part
    from evostencils_tpu_torch.problems import elasticity, poisson
    module = elasticity if build == "linear_elasticity_2d" else poisson
    problem = getattr(module, build)(max_level=max_level,
                                     min_level=min_level)
    return v_cycle(problem.level_contexts, problem.rhs_entity,
                   pre_smoothing=2, post_smoothing=1, omega=omega,
                   partitioning=getattr(part, partitioning),
                   coarse_operator=problem.coarsest_operator)


def count_syncs(torch, fn):
    """fn()'s result and the synchronizing CUDA operations it made, as
    torch's sync debug mode reports them."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_lfa(torch, device, card):
    """[lfa]: rho of each LFA_CASES cycle on the card by the power method
    and by exact eigenvalues; exact within LFA_EXACT_TOL of the JAX
    package's value, power within LFA_POWER_RTOL of exact.  Each method
    prints ms per rho (power: median of LFA_REPS after a warm-up; exact:
    its one run), the host's IR walk, the peak device memory of one rho,
    its frequency chunks and its host syncs."""
    from evostencils_tpu_torch.prediction.convergence import \
        ConvergenceEvaluator

    for name, (build, hi, lo, partitioning, omega, want) in \
            LFA_CASES.items():
        cycle = lfa_cycle(build, hi, lo, partitioning, omega)
        rho = {}
        for method in ("power", "exact"):
            ev = ConvergenceEvaluator(2, samples_per_axis=8, device=device,
                                      rho_method=method)
            # the first run: host syncs and peak device memory of one rho,
            # and exact's one timed run (the power method's warm-up)
            held = reset_peak_memory(torch)
            torch.cuda.synchronize()
            t = time.perf_counter()
            first, syncs = count_syncs(
                torch, lambda: ev.compute_spectral_radius(cycle))
            times = [(time.perf_counter() - t) * 1e3]
            peak = torch.cuda.max_memory_allocated() - held
            backend = ev.last_backend
            check(backend.thetas.device.type == "cuda",
                  f"[lfa] {name}: the LFA runs on the card")
            t = time.perf_counter()
            order = ev._symbol_handle(cycle)[1].rows
            walk = (time.perf_counter() - t) * 1e3
            rho[method] = first
            if method == "power":
                times = []
                for _ in range(LFA_REPS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    rho[method] = ev.compute_spectral_radius(cycle)
                    times.append((time.perf_counter() - t) * 1e3)
            log(f"[lfa] {name} {method}: rho {rho[method]!r}, "
                f"{statistics.median(times):.1f} ms per rho (median of "
                f"{len(times)}: {', '.join(f'{x:.1f}' for x in times)}), "
                f"the host's IR walk {walk:.1f} ms of it; order {order}, "
                f"{backend.n_theta} frequencies in {backend.last_chunks} "
                f"chunk(s), peak device memory {peak / 2**20:.1f} MiB above "
                f"{held / 2**20:.1f} MiB held, {syncs} host sync(s) per "
                f"rho; on {card}")
            check(abs(first - rho[method]) <= 1e-12 * rho[method],
                  f"[lfa] {name} {method}: the same rho on every run "
                  f"({first!r})")
        check(abs(rho["exact"] - want) <= LFA_EXACT_TOL,
              f"[lfa] {name}: exact rho {rho['exact']!r} against the JAX "
              f"package's {want!r}")
        check(abs(rho["power"] - rho["exact"])
              <= LFA_POWER_RTOL * rho["exact"],
              f"[lfa] {name}: power {rho['power']!r} against exact "
              f"{rho['exact']!r}")


#: [evolve-model]: the model-based CLI run at poisson2d's default levels
#: (9 -> 5); the best individual's estimate against its exact rho
EVOLVE_MODEL_RTOL = 1e-3


def phase_evolve_model(torch, kernels, device, card):
    """[evolve-model]: ``optimize poisson2d NSGAII --model-based --mu 2
    --lambda 2 --generations 1 --seed 0`` (9 -> 5): every candidate is
    scored by LFA on the card and the H100 roofline model, and nothing is
    solved, so no kernel launches.  Prints the evaluations, the wall time
    and the seconds per estimate; the best individual's estimated rho
    must lie within EVOLVE_MODEL_RTOL of its rho computed exactly, and its
    rho measured by the evaluator (float32 on the card) is printed
    beside."""
    from evostencils_tpu_torch import optimize
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.ir import transformations
    from evostencils_tpu_torch.optimization.program import Optimizer
    from evostencils_tpu_torch.prediction.convergence import \
        ConvergenceEvaluator

    estimate = Optimizer._estimate_objectives
    seconds = []

    def timed(self, individual):
        t = time.perf_counter()
        values = estimate(self, individual)
        seconds.append(time.perf_counter() - t)
        return values
    out_dir = ROOT / "evo_output" / "chip_smoke" / "poisson2d-model"
    argv = ["poisson2d", "NSGAII", "--model-based", "--mu",
            str(EVOLVE_POPULATION), "--lambda", str(EVOLVE_POPULATION),
            "--generations", "1", "--seed", "0", "--output", str(out_dir)]
    reset(kernels)
    Optimizer._estimate_objectives = timed
    t0 = time.perf_counter()
    try:
        result = optimize.main(argv)
    finally:
        Optimizer._estimate_objectives = estimate
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: n for k, n in counts_of(kernels).items() if n}
    log(f"[evolve-model] {' '.join(argv[:-2])}: {len(seconds)} estimates "
        f"in {wall:.1f} s wall, {statistics.mean(seconds):.3f} s per "
        f"estimate (median {statistics.median(seconds):.3f}, max "
        f"{max(seconds):.3f}); kernel launches {launched}; on {card}")
    check(len(seconds) > 0, "[evolve-model] candidates were estimated")
    check(not launched,
          "[evolve-model] a model-based run launched a solver kernel")

    problem = optimize.get_problem("poisson2d")
    pset = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)[0]
    best = result["grammar_string"]
    rho_estimate = result["best_individual"].fitness.values[0]
    expr = gp.compile_tree(gp.parse_tree(best, pset), pset)[0]
    transformations.assign_cycle_ids(expr)
    rho_exact = ConvergenceEvaluator(
        2, samples_per_axis=8, device=device,
        rho_method="exact").compute_spectral_radius(expr)
    evaluator = CycleEvaluator(problem, dtype=np.float32, device=device)
    evaluator.timing_enabled = False
    measured = evaluator.evaluate_expression(expr)
    log(f"[evolve-model] best individual: estimated rho {rho_estimate!r}, "
        f"exact LFA rho {rho_exact!r}, measured rho "
        f"{measured.convergence_factor!r} ({measured.iterations:.0f} "
        f"iterations, float32 on the card)")
    check(0 < rho_exact < 1e99
          and abs(rho_estimate - rho_exact) <= EVOLVE_MODEL_RTOL * rho_exact,
          f"[evolve-model] the best estimate {rho_estimate!r} against its "
          f"exact rho {rho_exact!r}")


#: [prescreen]: 16 individuals of the poisson_2d(9, 5) grammar
#: (genGrow(pset, 0, 50) from random.Random(PRESCREEN_SEED)) screened at
#: poisson_2d(6, 2), float32, on the card and on the CPU
PRESCREEN_COUNT = 16
PRESCREEN_SEED = 0
PRESCREEN_SMALL = (6, 2)
#: [prescreen]: a rejected member's small-grid rho on the two devices
#: (relative), and the distance from rho_cap at which a member is named
PRESCREEN_RTOL = 1e-3
PRESCREEN_MARGIN = 1e-3


def prescreen_screen(device):
    """SmallGridPrescreen's verdicts on the PRESCREEN_COUNT seeded
    individuals on ``device``: (verdicts, each member's small-grid rho,
    the rejected count, rho_cap, seconds)."""
    import random as _random
    import torch
    from evostencils_tpu_torch import optimize
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.optimization.prescreen import \
        SmallGridPrescreen
    from evostencils_tpu_torch.problems import poisson

    problem = optimize.get_problem("poisson2d")
    pset = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)[0]
    rng = _random.Random(PRESCREEN_SEED)
    individuals = [gp.genGrow(pset, 0, 50, rng=rng)
                   for _ in range(PRESCREEN_COUNT)]
    hi, lo = PRESCREEN_SMALL
    small = poisson.poisson_2d(max_level=hi, min_level=lo)
    small.dtype = np.float32
    pre = SmallGridPrescreen(small, device=device)
    population = pre.evaluator.evaluate_population
    rhos = []

    def kept(individuals, pset_small):
        results = population(individuals, pset_small)
        rhos.extend(r.convergence_factor for r in results)
        return results
    pre.evaluator.evaluate_population = kept
    t = time.perf_counter()
    verdicts = pre.screen(individuals, pset)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return verdicts, rhos, pre.rejected, pre.rho_cap, \
        time.perf_counter() - t


def phase_prescreen(torch, kernels, device, card):
    """[prescreen]: SmallGridPrescreen's verdicts on PRESCREEN_COUNT
    seeded individuals at 9 -> 5 against poisson_2d(6, 2) in float32, on
    the card and, at the same time in a child process, on the CPU: equal,
    a rejected rho within PRESCREEN_RTOL; every member whose small-grid
    rho lies within PRESCREEN_MARGIN of rho_cap is named.  Prints the time
    on each device."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        on_cpu = pool.submit(prescreen_screen, "cpu")
        reset(kernels)
        card_v, card_rho, rejected, cap, seconds = prescreen_screen(device)
        launched = {k: n for k, n in counts_of(kernels).items() if n}
        log(f"[prescreen] {PRESCREEN_COUNT} individuals on {card}: "
            f"{rejected} rejected in {seconds:.2f} s; kernel launches "
            f"{launched}")
        cpu_v, cpu_rho, rejected, _, seconds = on_cpu.result()
    log(f"[prescreen] {PRESCREEN_COUNT} individuals on the CPU (a child "
        f"process, beside the card's run): {rejected} rejected in "
        f"{seconds:.2f} s")
    check(len(card_rho) == len(cpu_rho) == PRESCREEN_COUNT,
          "[prescreen] every individual was measured on both devices")
    for i, (a, b) in enumerate(zip(card_rho, cpu_rho)):
        if min(abs(a - cap), abs(b - cap)) <= PRESCREEN_MARGIN:
            log(f"[prescreen] member {i} lies within {PRESCREEN_MARGIN} of "
                f"rho_cap {cap}: rho {a!r} on the card, {b!r} on the CPU; "
                f"verdicts {card_v[i]!r} / {cpu_v[i]!r}")
    log(f"[prescreen] verdicts on the card {card_v}")
    log(f"[prescreen] verdicts on the CPU  {cpu_v}")
    for i, (a, b) in enumerate(zip(card_v, cpu_v)):
        check((a is None) == (b is None)
              and (a is None or a == b
                   or abs(a - b) <= PRESCREEN_RTOL * max(abs(a), abs(b))),
              f"[prescreen] member {i}: verdict {a!r} on the card, {b!r} "
              f"on the CPU")


#: [procs]: the two evolutions run in 1 and in 2 processes: [evolve-model]'s
#: model-based run (9 -> 5) and a measured run at 255^2 (8 -> 4)
PROCS_RUNS = {
    "model": ("poisson2d", "NSGAII", "--model-based", "--mu", "2",
              "--lambda", "2", "--generations", "1", "--seed", "0"),
    "measured": ("poisson2d", "NSGAII", "--max-level", "8", "--min-level",
                 "4", "--mu", "2", "--lambda", "2", "--generations", "1",
                 "--seed", "0")}
#: [procs]: the model-based fitness of a member, 2 processes against 1
PROCS_FITNESS_RTOL = 1e-12
#: [procs]: seconds each launch (the 1-process run, the torchrun group) may
#: take before all its processes are killed
PROCS_CHILD_TIMEOUT_S = 150


def procs_rank(out):
    """[procs]' rank body (``chip_smoke.py --procs-rank OUT``), alone or
    under torchrun: forms the process group (``default_communicator``),
    takes its card (``setup_device``), runs each of PROCS_RUNS through
    ``optimize.main`` with the timing protocol off, and writes each run's
    wall seconds, evaluations (the optimizer's ``total_evaluations``: the
    new individuals of every generation, of all ranks), final population
    (strings and fitness) and best individual to ``OUT.rank<r>.json``."""
    import torch
    from evostencils_tpu_torch import optimize
    from evostencils_tpu_torch.config import setup_device
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.optimization.program import Optimizer
    from evostencils_tpu_torch.parallel import comm as comms

    comm = comms.default_communicator()
    device = setup_device("cuda")
    torch.ones(1, device=device).sum().item()     # the context, untimed
    CycleEvaluator.timing_enabled = False
    evaluate_invalid = Optimizer.evaluate_invalid
    evaluated = [0]

    def counted(self, individuals):
        n = evaluate_invalid(self, individuals)
        evaluated[0] += n
        return n
    Optimizer.evaluate_invalid = counted
    runs = {}
    for tag, args in PROCS_RUNS.items():
        comm.barrier()
        evaluated[0] = 0
        t0 = time.perf_counter()
        result = optimize.main(list(args) + [
            "--output", f"{out}-{tag}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best = result["best_individual"]
        runs[tag] = {
            "wall": wall,
            "evaluations": evaluated[0],
            "population": sorted([str(i), list(i.fitness.values)]
                                 for i in result["populations"][-1]),
            "best": result["grammar_string"],
            "best_fitness": list(best.fitness.values)}
    with open(f"{out}.rank{comm.rank}.json", "w") as f:
        json.dump({"rank": comm.rank, "size": comm.size,
                   "device": str(device), "runs": runs}, f)
    if isinstance(comm, comms.TorchProcessCommunicator):
        comm.close()


def run_child(tag, argv):
    """Run ``argv`` from the repository root in a session of its own; on a
    failure or after PROCS_CHILD_TIMEOUT_S seconds every process of the
    session is killed and the phase fails."""
    import signal
    proc = subprocess.Popen(argv, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=PROCS_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        check(False, f"[{tag}] {' '.join(argv)} ran over "
              f"{PROCS_CHILD_TIMEOUT_S} s; killed")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        log(f"[{tag}] {' '.join(argv)} failed:\n{out[-3000:]}\n"
            f"{err[-6000:]}")
    check(proc.returncode == 0, f"[{tag}] exit code {proc.returncode}")


def phase_procs(torch, device, card):
    """[procs]: PROCS_RUNS in 1 process and in 2 (torchrun, one card):
    the model-based run gives both ranks and the 1-process run the same
    population and best individual, fitness within PROCS_FITNESS_RTOL;
    the measured run gives both ranks the same population and a best
    individual that converges.  Prints each run's evaluations, wall
    seconds and evaluations a second."""
    from evostencils_tpu_torch import optimize
    from evostencils_tpu_torch.evaluation.evaluator import CycleEvaluator
    from evostencils_tpu_torch.grammar import gp
    from evostencils_tpu_torch.grammar.multigrid import generate_primitive_set
    from evostencils_tpu_torch.ir import transformations

    out_dir = ROOT / "evo_output" / "chip_smoke" / "procs"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    script = str(ROOT / "chip_smoke.py")
    run_child("procs", [sys.executable, script, "--procs-rank",
                        str(out_dir / "one")])
    run_child("procs", [sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2", script,
                        "--procs-rank", str(out_dir / "two")])
    one = json.loads((out_dir / "one.rank0.json").read_text())
    two = [json.loads((out_dir / f"two.rank{r}.json").read_text())
           for r in range(2)]
    check(one["size"] == 1 and [t["size"] for t in two] == [2, 2]
          and [t["rank"] for t in two] == [0, 1],
          "[procs] one process, then a group of two ranks")
    log(f"[procs] devices: 1 process {one['device']}, 2 processes "
        f"{[t['device'] for t in two]}; on {card}")
    for tag in PROCS_RUNS:
        for label, runs in (("1 process", [one]), ("2 processes", two)):
            r = runs[0]["runs"][tag]
            log(f"[procs] {tag} in {label}: {r['evaluations']} evaluations "
                f"in {r['wall']:.2f} s wall (rank 0), "
                f"{r['evaluations'] / r['wall']:.3f} evaluations a second; "
                f"best {r['best_fitness']}")
        a, b = (t["runs"][tag] for t in two)
        check(a["population"] == b["population"] and a["best"] == b["best"],
              f"[procs] {tag}: both ranks end with the same population")
    model = [one["runs"]["model"]] + [t["runs"]["model"] for t in two]
    strings = [[s for s, _ in r["population"]] for r in model]
    check(all(s == strings[0] for s in strings)
          and all(r["best"] == model[0]["best"] for r in model),
          "[procs] model: 2 processes end with the 1-process population and "
          "best individual")
    # each member's objectives and the best's, 1 process against rank 0
    one_two = [[f for _, f in r["population"]] + [r["best_fitness"]]
               for r in model[:2]]
    worst = max((abs(x - y) / max(abs(x), abs(y))
                 for a, b in zip(*one_two) for x, y in zip(a, b) if x != y),
                default=0.0)
    log(f"[procs] model: fitness of 2 processes against 1 within {worst:.3e}"
        f" relative")
    check(worst <= PROCS_FITNESS_RTOL, "[procs] model fitness")
    measured = one["runs"]["measured"], two[0]["runs"]["measured"]
    same = measured[0]["population"] == measured[1]["population"]
    log(f"[procs] measured: the 1- and 2-process populations are "
        f"{'equal' if same else 'different'}")

    problem = optimize.get_problem("poisson2d", 8, 4)
    pset = generate_primitive_set(
        problem.approximation, problem.rhs_entity, problem.level_contexts,
        problem.coarsest_operator)[0]
    expr = gp.compile_tree(gp.parse_tree(measured[1]["best"], pset), pset)[0]
    transformations.assign_cycle_ids(expr)
    evaluator = CycleEvaluator(problem, dtype=np.float32, device=device)
    evaluator.timing_enabled = False
    res = evaluator.evaluate_expression(expr)
    log(f"[procs] measured: the 2-process best individual re-evaluated: rho "
        f"{res.convergence_factor:.5f}, {res.iterations:.0f} iterations")
    check(np.isfinite(res.iterations) and res.iterations < evaluator.infinity
          and res.convergence_factor < 1,
          "[procs] the measured best individual converges")


#: [cma]: the tuner's hierarchy on the card (255^2 over 127^2: the dense
#: float64 A_c and its inverse take 2.1 GB each; at 511^2 over 255^2
#: they would take 33.8 GB each) and its settings
CMA_LEVELS = (8, 7)
CMA_SETTINGS = {"generations": 20, "smoothing_steps": 1,
                "measure_iterations": 10, "seed": 0}
#: [cma]: generation 0's fitness values on the card against the CPU's, at
#: poisson_2d(6, 5), relative
CMA_CHECK_LEVELS = (6, 5)
CMA_CPU_RTOL = 1e-10


def cma_generation0(device):
    """The fitness values of the tuner's generation 0 (the first ask of
    CMA_SETTINGS' CMA-ES around the default pair) at poisson_2d
    (CMA_CHECK_LEVELS) on ``device``, as numpy float64."""
    from evostencils_tpu_torch.optimization.cma import CMAES
    from evostencils_tpu_torch.optimization.intergrid_transfer import \
        TransferObjective
    from evostencils_tpu_torch.problems import poisson

    hi, lo = CMA_CHECK_LEVELS
    objective = TransferObjective(
        poisson.poisson_2d(max_level=hi, min_level=lo),
        smoothing_steps=CMA_SETTINGS["smoothing_steps"],
        measure_iterations=CMA_SETTINGS["measure_iterations"],
        seed=CMA_SETTINGS["seed"], device=device)
    es = CMAES(objective.default_weights(), sigma=0.1,
               seed=CMA_SETTINGS["seed"])
    return objective(es.ask())


def phase_cma(torch, device, card):
    """[cma]: ``intergrid_transfer.optimize`` on the card for
    poisson_2d and poisson_2d_variable at CMA_LEVELS: the tuned rho finite
    and no worse than the default pair's; seconds a generation (one
    batched call and one host read), the inverse's seconds (synchronized)
    and peak device memory; then generation 0 at CMA_CHECK_LEVELS on the
    card against the CPU (a spawned child, beside the card's runs)."""
    import concurrent.futures
    import multiprocessing
    from evostencils_tpu_torch.optimization import intergrid_transfer
    from evostencils_tpu_torch.problems import poisson

    inverse = torch.linalg.inv
    call = intergrid_transfer.TransferObjective.__call__
    inverse_s, call_s = [], []

    def timed_inverse(a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inverse(a)
        torch.cuda.synchronize()
        inverse_s.append(time.perf_counter() - t)
        return out

    def timed_call(self, weights):
        t = time.perf_counter()
        out = call(self, weights)
        call_s.append(time.perf_counter() - t)
        return out

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        on_cpu = pool.submit(cma_generation0, "cpu")
        for name in ("poisson_2d", "poisson_2d_variable"):
            hi, lo = CMA_LEVELS
            problem = getattr(poisson, name)(max_level=hi, min_level=lo)
            inverse_s.clear()
            call_s.clear()
            held = reset_peak_memory(torch)
            torch.linalg.inv = timed_inverse
            intergrid_transfer.TransferObjective.__call__ = timed_call
            t0 = time.perf_counter()
            try:
                result = intergrid_transfer.optimize(problem, device=device,
                                                     **CMA_SETTINGS)
            finally:
                torch.linalg.inv = inverse
                intergrid_transfer.TransferObjective.__call__ = call
            wall = time.perf_counter() - t0
            generations = call_s[1:]
            log(f"[cma] {name}({hi}, {lo}): {len(generations)} generations "
                f"recorded in the history ({len(result.history)})"
                f" in {wall:.2f} s wall; {statistics.mean(generations):.4f}"
                f" s a generation (median {statistics.median(generations):.4f}"
                f", max {max(generations):.4f}); the inverse "
                f"{inverse_s[0]:.3f} s; default rho "
                f"{result.default_convergence_factor!r}, tuned "
                f"{result.convergence_factor!r}; on {card}")
            peak_memory(torch, f"cma {name}", held)
            check(len(inverse_s) == 1 and len(generations)
                  == CMA_SETTINGS["generations"],
                  f"[cma] {name}: one inverse and one call a generation")
            check(np.isfinite(result.convergence_factor)
                  and result.convergence_factor
                  <= result.default_convergence_factor < 1,
                  f"[cma] {name}: tuned rho {result.convergence_factor} "
                  f"against the default {result.default_convergence_factor}")
            del result
            torch.cuda.empty_cache()
        on_card = cma_generation0(device)
        on_host = on_cpu.result()
    rel = np.abs(on_card - on_host) / np.abs(on_host)
    log(f"[cma] generation 0 at poisson_2d{CMA_CHECK_LEVELS}: card "
        f"{on_card.tolist()}; within {rel.max():.3e} relative of the CPU")
    check(rel.max() <= CMA_CPU_RTOL, "[cma] generation 0 on the card "
          "against the CPU")


#: [reference-cycles]: fixture -> (problem family, max level, min level,
#: the JAX tests' bound on rho (tests/test_reference_cycles.py:30-51; the
#: FAS fixtures must converge, :54-75))
REFERENCE_CYCLES = {"v22_two_grid": ("poisson", 7, 6, 0.1),
                    "v22_three_grid": ("poisson", 8, 6, 0.12),
                    "fas_v22_two_grid": ("fas", 5, 4, None),
                    "fas_v22_three_grid": ("fas", 5, 3, None)}
#: [reference-cycles]: cycles a solve may take (the JAX FAS tests' budget)
REFERENCE_MAX_ITERATIONS = 80


def reference_fixture(name):
    """(problem, cycle) of REFERENCE_CYCLES' fixture ``name``."""
    from evostencils_tpu_torch.ir import reference_cycles
    from evostencils_tpu_torch.problems import fas, poisson

    family, hi, lo, _ = REFERENCE_CYCLES[name]
    build = poisson.poisson_2d if family == "poisson" else fas.fas_2d_basic
    problem = build(max_level=hi, min_level=lo)
    levels = problem.level_contexts
    generate = getattr(reference_cycles,
                       f"generate_{name.replace('v22', 'v_22_cycle')}")
    middle = [] if name.endswith("two_grid") else [levels[1]]
    return problem, generate(levels[0], *middle, problem.coarsest_operator,
                             problem.rhs_entity)


def phase_reference_cycles(torch, kernels, device, card):
    """[reference-cycles]: each fixture solved to 1e-5 in float32 with the
    kernels and with the plain versions (compare_solves), the counts set
    to 0 just before; rho under its bound.  Returns the launches over the
    solves with the kernels; the 255^2 fixture must launch one at
    least."""
    from evostencils_tpu_torch.compiler.lower import lower_cycle
    from evostencils_tpu_torch.problems.poisson import build_rhs

    launches = {}
    for name, (_, hi, lo, rho_max) in REFERENCE_CYCLES.items():
        problem, cycle = reference_fixture(name)
        b = build_rhs(problem, dtype=torch.float32, device=device)
        reset(kernels)
        k, hist = compare_solves(
            torch, f"reference-cycles {name} {hi} -> {lo}", b,
            REFERENCE_MAX_ITERATIONS, lambda use: lower_cycle(
                cycle, problem.approximation, problem.rhs_entity,
                use_kernels=use))
        counts = {kernel: n for kernel, n in counts_of(kernels).items() if n}
        rho = hist[k] ** (1.0 / k)
        log(f"[reference-cycles] {name}: {k} iterations, rho {rho:.4f} "
            f"(bound {rho_max}); launches {counts}; on {card}")
        if rho_max is not None:
            check(rho < rho_max, f"[reference-cycles] {name} rho {rho}")
        if problem.level_contexts[0].grid[0].size[0] == 255:
            check(counts, f"[reference-cycles] {name}: no kernel launched "
                  "at 255^2")
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
    return launches


def main(argv=None):
    """Every phase, the ``kernels`` line and the result line; with
    ``--phases a,b,...`` (labels of the ``[time]`` lines) only the build
    and those phases, and no result line (a short run for a change)."""
    import argparse
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=None)
    parser.add_argument("--procs-rank", default=None,
                        help="[procs]' rank body only (procs_rank)")
    args = parser.parse_args(argv)
    if args.procs_rank is not None:
        procs_rank(args.procs_rank)
        return 0
    selected = None if args.phases is None else set(args.phases.split(","))
    start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from evostencils_tpu_torch.config import setup_device
    from evostencils_tpu_torch.ops.kernels import (_build, leg3d, rbgs,
                                                   rbgs3d, rbgs_cx, rbgs_sys,
                                                   rbgs_var, transfer,
                                                   wavefront3d)

    device = setup_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(f"[device] {card}")
    log(card)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    kernels = {"transfer": transfer, "wavefront3d": wavefront3d,
               "rbgs": rbgs, "rbgs3d": rbgs3d, "leg3d": leg3d,
               "rbgs_var": rbgs_var, "rbgs_sys": rbgs_sys,
               "rbgs_cx": rbgs_cx}

    def phase(label, fn, *args):
        if selected is not None and label not in selected:
            return {}
        t = time.perf_counter()
        out = fn(*args)
        log(f"[time] {label}: {time.perf_counter() - t:.1f} s")
        return out

    stats = phase("kernels", phase_kernels, torch, transfer, device)
    stats.update(phase("kernels-bf16", phase_kernels_bf16, torch, transfer,
                       device))
    stats.update(phase("kernels3d", phase_kernels_3d, torch, wavefront3d,
                       device))
    stats.update(phase("kernels-rbgs", phase_kernels_rbgs, torch, rbgs,
                       device))
    stats.update(phase("kernels-rr", phase_kernels_rr, torch, transfer,
                       device))
    stats.update(phase("kernels-sweep3d", phase_kernels_sweep3d, torch,
                       rbgs3d, leg3d, device))
    stats.update(phase("kernels-rr3d", phase_kernels_rr3d, torch, leg3d,
                       device))
    stats.update(phase("kernels-var", phase_kernels_var, torch, rbgs_var,
                       device))
    stats.update(phase("kernels-sys", phase_kernels_sys, torch, rbgs_sys,
                       device))
    stats.update(phase("kernels-loop", phase_kernels_loop, torch, transfer,
                       device))
    stats.update(phase("kernels-cx", phase_kernels_cx, torch, rbgs_cx,
                       device))
    launches = phase("main", phase_main_path, torch, kernels, device, card,
                     "2d")
    phase("main solve", phase_solve, torch, device, "2d")
    launches.update(phase("main-fused", phase_main_fused, torch, kernels,
                          device, card))
    launches.update(phase("main3d", phase_main_path, torch, kernels, device,
                          card, "3d"))
    phase("main3d solve", phase_solve, torch, device, "3d")
    # the var and system legs' launches over both partitionings' runs
    for path in ("var-jacobi", "var-rb", "elast-rb", "elast-jacobi"):
        for kernel, count in phase(PATHS[path][0], phase_main_path, torch,
                                   kernels, device, card, path).items():
            launches[kernel] = launches.get(kernel, 0) + count
        phase(PATHS[path][0] + " solve", phase_solve, torch, device, path)
    launches.update(phase("evaluator", phase_evaluator, torch, kernels,
                          device, card))
    phase("evolve", phase_evolve, torch, kernels, "poisson2d", "evolve", (),
          EVOLVE_TIMING_REPS)
    launches.update(phase("evaluator3d", phase_evaluator_3d, torch, kernels,
                          device, card))
    phase("evolve3d", phase_evolve, torch, kernels, "poisson3d", "evolve3d",
          STANDALONE3)
    launches.update(phase("evaluator-var", phase_evaluator_var, torch,
                          kernels, device, card))
    phase("evolve-var", phase_evolve, torch, kernels, "poisson2d_var",
          "evolve-var", VAR_SWEEPS + VAR_LEGS, EVOLVE_TIMING_REPS)
    launches.update(phase("evaluator-elast", phase_evaluator_elast, torch,
                          kernels, device, card))
    phase("evolve-elast", phase_evolve, torch, kernels, "elasticity2d",
          "evolve-elast", SYS_SWEEPS + SYS_LEGS)
    # the complex path: each cycle's sweeps over both partitionings' runs
    for path in ("cx-rb", "cx-jacobi"):
        launches.update(phase(PATHS[path][0], phase_main_path, torch,
                              kernels, device, card, path))
        phase(PATHS[path][0] + " solve", phase_solve, torch, device, path)
    helm_iterations = phase("helm", phase_helm, torch, kernels, device, card)
    phase("evaluator-helm", phase_evaluator_helm, torch, kernels, device,
          card)
    phase("evolve-helm", phase_evolve, torch, kernels, "helmholtz2d",
          "evolve-helm", (), None, EVOLVE_HELM_OPTIONS)
    # the split-complex path: the system legs' launches over both runs
    for path in ("split-rb", "split-jacobi"):
        for kernel, count in phase(PATHS[path][0], phase_main_split, torch,
                                   kernels, device, card, path).items():
            launches[kernel] = launches.get(kernel, 0) + count
        phase(PATHS[path][0] + " solve", phase_solve, torch, device, path)
    split_iterations = phase("helm-split", phase_helm_split, torch, kernels,
                             device, card, helm_iterations)
    held = reset_peak_memory(torch)
    phase("evolve-split", phase_evolve, torch, kernels, "helmholtz2d_split",
          "evolve-split", (), None, EVOLVE_HELM_OPTIONS,
          EVOLVE_SPLIT_MAX_ITERATIONS, EVOLVE_SPLIT_SEED)
    peak_memory(torch, "evolve-split", held)
    for kernel, count in phase("main-fas", phase_main_fas, torch, kernels,
                               device, card).items():
        launches[kernel] = launches.get(kernel, 0) + count
    phase("evolve-fas", phase_evolve, torch, kernels, "fas2d", "evolve-fas",
          (), None, EVOLVE_FAS_LEVELS, EVOLVE_FAS_MAX_ITERATIONS)
    # the deep solves: rows 1-2 from [deep] and [deep-fas] add to their
    # float32 counts, their bf16 forms run in [deep-bf16] alone
    for out in (phase("deep", phase_deep, torch, kernels, device, card),
                phase("deep-fas", phase_deep_fas, torch, kernels, device,
                      card),
                phase("deep-bf16", phase_deep, torch, kernels, device, card,
                      True)):
        for kernel, count in out.items():
            launches[kernel] = launches.get(kernel, 0) + count
    phase("deep-split", phase_deep_split, torch, kernels, device, card,
          split_iterations)
    # level-chunked programs and the CG coarse solve: rows 1-2 add the
    # composed program's and chunk 0's launches
    for out in (phase("chunked", phase_chunked, torch, kernels, device,
                      card),
                phase("cg", phase_cg, torch, kernels, device, card)):
        for kernel, count in out.items():
            launches[kernel] = launches.get(kernel, 0) + count
    phase("evolve-chunked", phase_evolve_chunked, torch, kernels, device,
          card)
    # model-based evaluation: LFA on the card, then the CLI's estimate path
    # and the small-grid prescreen
    phase("lfa", phase_lfa, torch, device, card)
    phase("evolve-model", phase_evolve_model, torch, kernels, device, card)
    phase("prescreen", phase_prescreen, torch, kernels, device, card)
    # one evolution in two processes on the card, the transfer-weight
    # tuner, and the hand-built fixtures, whose 255^2 solve adds launches
    phase("procs", phase_procs, torch, device, card)
    phase("cma", phase_cma, torch, device, card)
    for kernel, count in phase("reference-cycles", phase_reference_cycles,
                               torch, kernels, device, card).items():
        launches[kernel] = launches.get(kernel, 0) + count
    for banned in ("jax", "evostencils_tpu"):
        check(banned not in sys.modules, f"the port imported {banned}")
    log(f"[done] all phases in {time.perf_counter() - start:.1f} s")
    if selected is not None:
        return 0

    rows = []
    for k, (replaces, source) in KERNELS.items():
        s = stats[k]
        rows.append({"name": k, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[k],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
