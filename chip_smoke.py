#!/usr/bin/env python3
"""Run the torch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):

1. card and build: name and power limit from nvidia-smi; the build of every
   source in ``triangulation_in_deformable_scenes_torch/csrc`` (one nvcc per
   source, all started together, linked into one library), timed, with
   ptxas's register, shared-memory and spill lines for every kernel.
2. kernel 1 (damped Cholesky): the CUDA kernel against its plain PyTorch
   version on the card at dims 377 and 746 (the sequence path's rigid and
   general solves), 728 (the 240-point rigid solve), 1448 (the 240-point
   general solve), 2591 (the 861-point rigid solve), 3048 (bundle
   adjustment) and 4096 (the dense ceiling), diagonal scales 1e-3..1e5, relative error < 1e-5 of
   max|x|; REPEATS more calls on the same input bit-identical to the first;
   ``torch.profiler`` sees one CUDA launch per solve, of
   ``damped_solve_kernel`` and nothing else; a non-PD system must give
   non-finite output. Times by CUDA events (median of 30 after warm-up) for
   the kernel, the plain version and one ``cholesky_ex`` +
   ``cholesky_solve`` library call of the same function, and the kernel's
   device time from the profiler beside them.
   Then the main path's own first system (H, g at full width, dim 1448,
   condition number about 1e6 after equilibration) and a synthetic one of
   that condition number: there the kernel's error against an f64 solve may
   be at most twice the plain version's. Last a refinement case whose
   error against an f64 solve must lie below a limit that the kernel's own
   unrefined solution x0 (read from its workspace) exceeds, so that a kernel
   without a working refinement step fails.
3. kernel 2 (block PCG): the large-N path's own first block system (the
   pipeline's steps up to the first ``solve_pair``) at 861 points (dim 5174,
   the reference's problem size) and 2600 points (dim 15608, the JAX
   package's bigN scale). At CG_ITERS/CG_RTOL the kernel takes the plain
   version's iteration count and lands within PCG_REL_TOL of max|x| and
   within PCG_ACCURACY_FACTOR of the plain version's error against an f64
   run; at rtol 1e-6 with the cap raised its x solves the system for two
   right-hand sides (-g, and one that loads the global block), the residual
   of the plain operator (in f64) at most 2 rtol ||b||, so a kernel without
   the neighbour, global-coupling, Hg or preconditioner terms fails; at
   rtol 0 it runs exactly the cap; REPEATS more calls are bit-identical to
   the first, and ``torch.profiler`` sees one ``pcg_kernel`` launch per
   solve. The kernel's device time from ``torch.profiler`` (also of the
   tight solve, for the time per iteration; CUDA events around one call and
   the wrapper's host time are shown beside it), its phase split from the
   SM clock of block 0 (``tids_pcg_solve_timed``), the grid, the plain
   version's time by CUDA events, and the bound. The same checks on the
   861-point system repeated until it no longer fits the resident kernel
   (the strided kernel, fewer warps than points), and on the serving block
   branch's own first system (phase 18's fixture, pair 0, 680 points).
4. main path: the synthetic two-view simulation at full width (240 points,
   tangent dim 1448; ``harness/sweep_config.py``) through
   ``SimulationPipeline(device="cuda")`` with the launch counts reset just
   before and read just after; its initial and final mean 3D errors are held
   against the JAX package's CPU values below.
5. split: one round of the same run with the LM loop's assembly, solve and
   cost timed between synchronizes, and one inner solve under
   ``torch.profiler`` for the device's busy and idle time.
6. cross-device: the reduced fixture of tests/test_torch_pipeline.py on cuda
   against cpu, with that test's limits.
7. large-N main path: the same simulation at 861 points, full budget, on
   the block-PCG backend (general solves, dim 5174) and kernel 1 (rigid
   solves, dim 2591), counts reset just before and read just after: PCG
   launches equal the general LM solves, kernel-1 launches at dim 2591 the
   rigid ones; initial and final errors held against the JAX CPU values.
   Then the split of one round at 861 points as in phase 5.
8. bigN: ``deformable.solve_pair`` at 2600 points for 10 LM iterations (as
   ``bench.py:636-673``) on cuda and on the port's CPU from the same first
   state: the same accepted count, the cost within TIED_RTOL after
   TIED_ITERS iterations and within BIGN_COST_RTOL after 10 (see the note
   at TIED_ITERS); LM iterations per second on the card.
9. cross-device at 861 points: the first large-N ``solve_pair`` with the
   kernel against the plain PCG on cuda and against the CPU after
   1..TIED_ITERS LM iterations: the same accepted count and damped-solve
   count, lambda and cost within TIED_RTOL of the plain run on cuda, and of
   the CPU while both devices' PCG solves took the same iteration counts.
10. kernel 3 (the matcher's windowed Hamming top-2 scan): the CUDA kernel
   against its plain version on the card, all three outputs (best
   distance, first-occurrence argmin, second-best) and the matches and
   count after the ratio test and ``_one_to_one`` bit-identical, on the
   full-width frames' own keypoints (1000 x 1000, the sequence path's
   call), on the JAX package's sweep sizes 1024^2..8192^2 (window 100,
   octave 0, as bench.py:747-790), on a planted-tie case and on empty rows,
   and on ties that the kernel's lanes must merge by column (within and
   across lanes and column tiles); REPEATS more scans bit-identical, and
   ``torch.profiler`` sees the MATCH_LAUNCHES_PER_SCAN launches of one scan
   (the bit packing, the scan). Device time of both from
   ``torch.profiler`` (CUDA events around the wrapper and its host time
   beside it), the plain version's by CUDA events (median of 30 after
   warm-up), and the bound.
11. the sequence path: the rendered two-depth step scene at full width
   (``harness/step_scene.py`` FULL: 1024 x 1024, 1000 features in 8
   scales, pair preset 1024_00000_1229-1236, 5 rounds x 8 evals x 25
   iterations) through ``SequencePipeline(device="cuda").run``, counts
   reset just before and read just after: kernel-3 launches equal the
   pair attempts, kernel-1 launches the damped solves; keypoints, matches,
   triangulated points, parallax and the initial and final mean 3D errors
   held against the JAX CPU values below. Each frame's extraction, the
   match, ``initialize_pair`` and the refinement timed between
   synchronizes; one warm extraction under ``torch.profiler`` for the
   device's idle share.

12. features on the card: the patch blur (seven taps summed in XLA's CPU
   order) and the angle moments (XLA's matrix-vector order) on the card
   bit for bit the CPU's, angles within 2 ulp.
13. the sweep harness: ``harness/sweep.run_sweep`` on the card over the two
   generated conditions of the entry point's docstring example
   (ARAP_depth_3mm, InRays, 20 cm, Planar, types 2 and 5, repetition 2;
   one shared ``default_rng(0)``; ``sweep_config()`` at the sweep's full
   budget, 5 rounds x 8 evaluations x 25 LM iterations), counts reset just
   before and read just after: kernel-1 launches equal the damped solves;
   per condition n_valid equal to the JAX CPU run's, the initial error
   within INITIAL_TOL_M and the final within FINAL_REL_TOL of it; the
   ``write_condition_csv`` table of the two journals holds the header and
   the rows that ``journal_to_row`` reads from them.
14. the pose-free bootstrap: the full-width step scene through
   ``SequencePipeline(device="cuda")`` with a loader that yields no poses
   (one round of the refinement, POSEFREE_BUDGET).
   Its RANSAC draws come from a generator on the card, which draws
   otherwise than JAX's ``jax.random`` (and than the CPU's generator), so
   the pose is held to the scene's truth, not to JAX: R21 within
   POSEFREE_ROT_TOL_DEG of the identity, t21's direction within
   POSEFREE_TDIR_TOL_DEG of the true baseline's and |t21| within
   POSEFREE_SCALE_RTOL of 0.0806 m (see those constants for why they are
   wider than a single draw's error); the generator is seeded, so the pose
   is also held within a small band of the card's own recorded draw
   (POSEFREE_CARD_*); kernel-3 launches equal the pair
   attempts, kernel-1 launches the damped solves; matches and map points
   within the sequence tolerances of the JAX known-pose run; a finite
   final error.
15. the two remaining selections on the card, on the reduced fixture of
   phase 6: ``open3DArap`` (its Laplacian LU by ``torch.linalg``, no
   kernel) final within OPEN3D_TOL_M of the JAX CPU value, ``eigen``
   final within FINAL_REL_TOL, with kernel-1 launches equal to its damped
   solves; then ``eigen`` from an ARAP weight of 0.1 with a wide
   forward-difference step (EIGEN_WIDE_*, as
   ``tests/test_torch_selections.py``), whose steps follow the objective
   and not the f32 rounding: the weights JAX's (down to the 1e-5 bound) and
   the final within EIGEN_WIDE_REL_TOL of JAX's.
16. the visualisers and the map layer: the reduced fixture's simulation
   (one round of one evaluation, VIZ_BUDGET) with ``show_scene`` and
   ``show_solution`` on the card; the snapshot PNG reads
   back (``viz.draw.read_png``) at its size with drawn pixels, the PLY holds
   the 2 x n_valid refined points (and the two camera centres), and
   ``world_map`` holds n_valid map-point pairs.
17. kernel 1's batched entry (one cooperative launch for a batch of systems
   of one dim, the serving path's solve) at B in BATCHES and dims
   BATCH_DIMS on ``make_system`` inputs: every member bit for bit the
   single launch's; ``torch.profiler`` sees one ``damped_solve_kernel``
   launch per batched call; REPEATS more calls bit-identical; with one
   non-PD member only that member's row non-finite (the others the single
   launch's). Times by CUDA events (median of 30): the batched call, B
   single launches, the plain version and the library's batched
   ``cholesky_ex`` + ``cholesky_solve``; the bound is B times the single
   system's.
18. serving (``harness/serving.py``, the JAX package's serving fixture,
   bench.py:676-744, with JAX's frozen rotations pinned at the vertices
   that the draw leaves free: the note at SERVING_TIED_ITERS), counts reset
   just before each run and read just after: ``solve_pairs`` on 16 pairs
   of 128 points (dim 776) for 25 iterations makes one batched kernel-1
   launch per global step, all at (16, 776); ``solve_pairs_pipelined`` one
   single launch per damped solve; per pair the two give the same
   n_accepted and costs within 1e-5, and JAX's n_accepted and a cost
   within TIED_RTOL of JAX's after one iteration and FINAL_REL_TOL after
   25; throughput under bench.py's keys, the split of one global step
   (assembly, solve, cost) and the peak device memory. Then the block
   branch, 16 pairs of 680 points (dim 4088, over DENSE_J_BUDGET_BYTES;
   kernel 2 is held to its plain version on pair 0's first system in
   phase 3) for 3 iterations: kernel-2 launches equal the pairs' damped
   solves (16 a global step), each pair the same as alone on the block
   backend, JAX's n_accepted and costs within TIED_RTOL of JAX's after one
   iteration and after 3.
19. bundle adjustment (``harness/ba_scene.py``, tests/test_worldmap_ba.py's
   scene at 8 keyframes x 1,000 points, dim 3,048): every observation in
   front of its camera; kernel-1 launches equal the damped solves, at dim
   3,048; two runs bit-identical; the fixed poses unmoved; the final cost
   and mean point error held to JAX's; ``pose_only_optimization`` on 1,000
   points with 50 outliers gives JAX's mask and pose within 1e-5 (kernel 1
   at dim 6); ``local_bundle_adjustment`` JAX's (n_edges, n_removed).

20. ``parallel/`` (``harness/scaling.py``: the JAX package's scaled pair,
   bench.py:889-950, 16,384 points, dim 98,312, 5 LM iterations at
   cg_iters 32, JAX's rotations pinned at its 66 free vertices). The ranks
   are subprocesses (``parallel/launch.run_ranks`` running
   ``_parallel_rank``; the multihost worker), each with a wall-clock limit;
   a rank that exits non-zero fails the phase. The plans' boundary counts
   equal JAX's; kernel 2 held to its plain version on the pair's first
   system (``pcg_check``). World 1 on NCCL, alone on the card:
   ``solve_pair_distributed`` and ``solve_pair_halo`` after 1 and 5
   iterations, kernel-2 launches equal to the damped solves, no collective
   in the solves, costs within PARALLEL_TIED_RTOL / FINAL_REL_TOL of JAX's
   and the halo solve within HALO_ONE_SHARD_RTOL of the baseline; then one
   NCCL all_reduce of the last cost, which must come back unchanged (also
   after serving at world 1). Then at once: serving
   (phase 18's fixture and budget) sharded by pair at world 1 on NCCL;
   world 2 over gloo on the one card (asked for by name: NCCL takes one
   card a rank): the halo solve, the baseline on the multihost worker's
   5 x 5 problem (padded to 26) and on the scaled pair, serving; world 4
   over gloo: the halo solve; and the multihost worker at 2 ranks in both
   modes. One sharded damped solve of the pair's first system (halo at
   worlds 2 and 4, the baseline at 2) takes the plain one-device PCG's
   iteration count and lands within PCG_SHARDED_RTOL of its x, the same
   bits on every rank. Every landmark-sharded run: the ranks' costs bit for bit equal,
   within the limits of JAX's, three all-reduces a CG iteration, the
   matvec exchange 6 |B| + 8 floats (halo) or 6 N + 8 (baseline), no kernel
   launched (the sharded PCG is plain torch with collectives). Serving:
   every pair bit for bit the unsharded ``solve_pairs``', one batched
   kernel-1 launch a global step on each rank. Walls and exchange sizes are
   logged; ranks sharing one card measure no scaling.

Then it prints the ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``. It exits non-zero without a card, and
when run from a directory that does not hold the package.

Reference values (``JAX_*``): the JAX package on the CPU, same fixture, seed
and budget, produced by

    JAX_PLATFORMS=cpu python tests/test_torch_problems.py --points 240 --rounds 5 --evals 8 --iters 25
    JAX_PLATFORMS=cpu python tests/test_torch_problems.py --points 861 --rounds 5 --evals 8 --iters 25
    JAX_PLATFORMS=cpu python tests/test_torch_sequence.py --rounds 5 --evals 8 --iters 25
    JAX_PLATFORMS=cpu python tests/test_torch_harness.py
    JAX_PLATFORMS=cpu python tests/test_torch_problems.py --points 60 --rounds 2 --evals 5 --iters 10 --set 'opt_selection="open3DArap"'
    JAX_PLATFORMS=cpu python tests/test_torch_problems.py --points 60 --rounds 2 --evals 5 --iters 10 --set 'opt_weights_selection="eigen"'
    JAX_PLATFORMS=cpu python tests/test_torch_selections.py
    JAX_PLATFORMS=cpu python tests/test_torch_serving.py
    JAX_PLATFORMS=cpu python tests/test_torch_bundle_adjustment.py
    JAX_PLATFORMS=cpu python tests/test_torch_parallel.py

(the sequence, sweep, serving and BA runs with ``--port`` give the port's
own CPU values; the ``SEQ_*``, ``SERVING_*`` and ``BA_*`` tolerances are set
from them).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "triangulation_in_deformable_scenes_torch"

# JAX package, CPU, 240 points, seed 0, 5 rounds x 8 evals x 25 iterations:
# n_valid 240, rounds 5, weights (1, 1, 1e-5).
JAX_N_VALID = 240
JAX_INITIAL_AV_ERROR_M = 0.002630718311990156
JAX_FINAL_AV_ERROR_M = 0.006566227470367649
# Initial errors come from the same f32 triangulation on both: 1e-6 m.
INITIAL_TOL_M = 1e-6
# Final errors come from ~1,200 f32 LM solves whose accept/reject decisions
# can flip on last-ulp differences between devices and summation orders. The
# port on the CPU lands 0.19 % from the JAX value on this fixture; 2 % leaves
# ten times that for the card's other summation order.
FINAL_REL_TOL = 0.02

# The reduced cross-device run (tests/test_torch_pipeline.py's condition and
# limits: initial error 1e-6 m, final error 5e-7 m, weights rtol 1e-6).
REDUCED = dict(num_points=60, rounds=2, evals=5, iters=10)
CROSS_FINAL_TOL_M = 5e-7
CROSS_WEIGHTS_RTOL = 1e-6

# Kernel against the plain version on well-conditioned systems: relative to
# max|x|.
KERNEL_REL_TOL = 1e-5
# On systems whose equilibrated condition number is about 1e6 (the main
# path's own first system, and a synthetic one) the kernel and the plain
# version each land about 1e-2 of max|x| from an f64 solve, in different
# directions, so they are held to that solve instead: the kernel's error at
# most ACCURACY_FACTOR times the plain version's.
ACCURACY_FACTOR = 2.0
ILL_COND = 1e6
# The refinement case: condition number 10, and an upper triangle that
# differs from the lower one by a relative 1e-3. The factor sees only the
# lower triangle, the refinement's residual the whole matrix, so only a
# working refinement step brings x near the solution of the whole matrix.
# REFINE_LIMIT lies between the kernel's refined x and its own unrefined x0
# (readings in PERF.md).
REFINE_COND = 10.0
REFINE_UPPER_ETA = 1e-3
REFINE_LIMIT = 1e-4

# The large-N path: 861 points, tangent dim 5174 (the reference's own
# problem, BASELINE.md:41). JAX package, CPU, seed 0, 5 rounds x 8 evals x
# 25 iterations: n_valid 861, rounds 1, weights (1, 1, 1.78e6); the outer
# loop keeps the initial state, so final equals initial.
LARGE_POINTS = 861
JAX_LARGE_N_VALID = 861
JAX_LARGE_INITIAL_AV_ERROR_M = 0.0025431607710623793
JAX_LARGE_FINAL_AV_ERROR_M = 0.0025431607710623793
# The JAX package's bigN scale (bench.py:537, 636-673): 2600 points, dim 15608.
BIGN_POINTS = 2600
BIGN_ITERS = 10

# Kernel 2 against the plain version at CG_ITERS/CG_RTOL: the same iteration
# count, x within PCG_REL_TOL of max|x|, and the kernel's error against an
# f64 run of the same iterations at most PCG_ACCURACY_FACTOR times the plain
# version's. The two sum in other orders and invert the 8x8 global block by
# Cholesky and by LU; and the first systems' 6x6 blocks are conditioned so
# that an f32 solve lands 1.6e-4 (861 points) and 1.6e-3 (2600 points) of
# max|x| from the f64 one (the plain version on the CPU), so two f32 solves
# may differ by as much.
PCG_REL_TOL = 1e-2
PCG_ACCURACY_FACTOR = 2.0
# A tight solve: tolerance, raised cap, and the cap run at rtol 0.
PCG_TIGHT_RTOL = 1e-6
PCG_TIGHT_CAP = 1000
PCG_CAP_ITERS = 20
# The large-N LM trajectory from the first state is sensitive to rounding:
# each accepted step lowers the cost ~3x under damping lambda ~1e14..1e15,
# and runs of the same solve in f32 on the card (kernel or plain), f32 on
# the CPU and f64 on the CPU separate after 4-7 iterations (readings of
# ``python3 chip_diagnostics.py rounding`` in PERF.md). So cuda and cpu are
# held tightly while the runs are tied, and loosely after.
# bigN cuda vs cpu: the same accepted count, the cost after TIED_ITERS
# iterations within TIED_RTOL (read: 8.6e-4) and after BIGN_ITERS within
# BIGN_COST_RTOL (read: 0.30).
TIED_ITERS = 3
TIED_RTOL = 1e-2
BIGN_COST_RTOL = 0.5
# Cross-device at 861 points: after each of 1..TIED_ITERS LM iterations the
# same accepted and solve counts, lambda and cost within TIED_RTOL of the
# card's plain PCG (read: lambda 1.1e-4, cost 5.5e-3 at 3 iterations) and of
# the CPU while the devices' PCG iteration counts agree (read: cost 1.0e-3
# at 2 iterations; at 3 the CPU's third solve takes 3 PCG iterations, the
# card's 2).

# The sequence path (phase 11). JAX package, CPU, full-width step scene, 5
# rounds x 8 evals x 25 iterations: 1000 valid keypoints in each frame, 125
# matches, 250 map points, weights (1, 1, 1e7). The port on the CPU, the same
# run: 1000 / 1000 keypoints, 124 matches, 248 map points, the same parallax
# to 1e-12 deg, initial error 0.38 % and final error 0.28 % from JAX (the
# keypoints agree; resampling flips ~1 % of level-1 descriptor bits, which
# moves a match across the ratio test). Tolerances: ten times that spread.
JAX_SEQ_N_VALID = (1000, 1000)
JAX_SEQ_N_MATCHES = 125
JAX_SEQ_N_TRIANGULATED = 250
JAX_SEQ_PARALLAX_DEG = 2.5630764961242676
JAX_SEQ_INITIAL_AV_ERROR_M = 0.3699426565891309
JAX_SEQ_FINAL_AV_ERROR_M = 0.36401198483945235
SEQ_COUNT_REL_TOL = 0.08  # matches and map points (spread: 1 of 125)
SEQ_ERROR_REL_TOL = 0.04  # initial and final mean 3D error (spread: 0.38 %)
# The parallax is the 51st-largest ray angle of the valid matches (2.5631 deg
# on both CPUs): a match more or fewer above it shifts it by one rank, and
# the neighbouring ranks lie 0.003-0.12 deg apart here (ranks 46-56 span
# 2.39-2.75 deg, the port on the CPU); 0.15 deg admits two ranks.
SEQ_PARALLAX_TOL_DEG = 0.15

# Kernel 3 at the JAX package's sweep sizes (bench.py:747-790).
MATCH_SWEEP = (1024, 2048, 4096, 8192)
# CUDA launches of one scan: the bit packing, then the scan.
MATCH_LAUNCHES_PER_SCAN = 2
MATCH_SWEEP_WINDOW = 100.0

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
# Sweep harness (phase 13): the JAX package's values of the two conditions
# on the CPU (tests/test_torch_harness.py run as a script), by type.
SWEEP_CONDITION = dict(model="ARAP_depth_3mm", triangulation="InRays", depth_cm=20, shape="Planar", experiment=2)
JAX_SWEEP = {
    2: dict(n_valid=240, initial=0.002619957654194584, final=0.0008434420145851891),
    5: dict(n_valid=240, initial=0.002633339946995788, final=0.000993773200551332),
}

# Pose-free bootstrap (phase 14), held to the step scene's truth: camera 2
# at the baseline (0.08, 0.01, 0) m with camera 1's orientation. Over 14
# draws of the 17-hypothesis RANSAC (JAX's key 10 and the port's generator
# seeds 0..11 on the CPU, the port's seed 10 on the card) the recovered pose
# lay 0.00-0.57 deg from the identity, its t direction 1.9-11.7 deg from the
# baseline's (JAX's own draw: 11.6 deg) and |t| 11.4 % below to 5.1 % above
# 0.0806 m: 17 minimal sets on a two-plane scene with an 8 cm baseline pin
# the direction of t loosely. The limits take that spread with a margin.
POSEFREE_BASELINE_M = (0.08, 0.01, 0.0)
POSEFREE_ROT_TOL_DEG = 1.0
POSEFREE_TDIR_TOL_DEG = 15.0
POSEFREE_SCALE_RTOL = 0.15
# The card's own draw (generator seeded 10), the same in every recorded run
# (NVIDIA H100 80GB HBM3, 700 W): a band far inside the spread above, so a
# systematic error in the pose shows.
POSEFREE_CARD_ROT_DEG = 0.5739
POSEFREE_CARD_TDIR_DEG = 7.955
POSEFREE_CARD_NORM_M = 0.07144
POSEFREE_CARD_BAND = (0.01, 0.05, 1e-4)  # deg, deg, m
POSEFREE_BUDGET = (1, 8, 25)  # rounds, search evaluations, LM iterations
# The visualisers need a refined state, not a converged one.
VIZ_BUDGET = dict(rounds=1, evals=1, iters=2)

# The two remaining selections (phase 15) on the reduced fixture: JAX CPU
# values (tests/test_torch_problems.py with --set, see the docstring).
JAX_OPEN3D_FINAL_AV_ERROR_M = 0.010825837890464422
JAX_EIGEN_FINAL_AV_ERROR_M = 0.010112001756259304
JAX_REDUCED_INITIAL_AV_ERROR_M = 0.002492060152149302
OPEN3D_TOL_M = 1e-5  # one f32 LU of the same Laplacian on each side
# eigen with a forward-difference step of half the weight, from an ARAP
# weight of 0.1, one round of 2 LM iterations: JAX CPU values from
# ``JAX_PLATFORMS=cpu python tests/test_torch_selections.py`` (the port on the
# CPU: 0.005528054234527198 m, the same weights).
EIGEN_WIDE_EPS_REL = 0.5
EIGEN_WIDE_OVERRIDES = {"opt_weights_selection": "eigen", "opt_arap_weight": 0.1}
EIGEN_WIDE_BUDGET = dict(rounds=1, evals=1, iters=2)
JAX_EIGEN_WIDE_WEIGHTS = (1.0, 1.0, 1e-05)
JAX_EIGEN_WIDE_FINAL_AV_ERROR_M = 0.005528058414085878
EIGEN_WIDE_REL_TOL = 1e-4

# Kernel 1's batched entry (phase 17): batch sizes and dims (the pose-only
# solve's 6, the serving fixture's 776, the 240-point path's 1448).
BATCHES = (1, 4, 16)
BATCH_DIMS = (6, 776, 1448)

# Serving (phase 18): harness/serving.py's fixtures. JAX package, CPU
# (tests/test_torch_serving.py run as a script): solve_pairs after
# SERVING_TIED_ITERS iteration (*_TIED) and at the full budget, and
# solve_pairs_pipelined, on the 16 x 128-point batch (25 iterations); the
# block branch, 16 x 680 points (3 iterations). The fixture's pixels are
# drawn apart from its points, and in 6 of the 16 dense pairs (every block
# pair) some vertex keeps one weighted mesh edge: its frozen rotation is
# free about that edge (``serving.free_vertices``), and each device's SVD
# picks its own. The card's fixtures are pinned to JAX's rotations at those
# vertices (*_FREE_RI: {pair: {vertex: R row-major}}), so every pair is
# JAX's problem. The port on the CPU, pinned: within 2.5e-7 of JAX after
# one iteration and 7.5e-5 after 25 (block: 9.4e-6 and 5.2e-4), n_accepted
# equal (``--port``). Held to TIED_RTOL after one iteration and
# FINAL_REL_TOL after 25, the block branch to TIED_RTOL after 3: on the
# CPU, a PCG whose steps are 1 % short, or that stops at rtol 0.1, leaves
# 11 and all 16 block pairs outside TIED_RTOL after 3 iterations.
SERVING_TIED_ITERS = 1
JAX_SERVING_DENSE_TIED_COST = [125344.9453125, 122610.5078125, 113744.5078125, 146078.359375, 95564.78125, 170571.578125, 144271.890625, 136833.828125, 130916.234375, 182270.140625, 145255.703125, 141047.71875, 128652.84375, 217511.28125, 133477.578125, 121124.53125]
JAX_SERVING_DENSE_TIED_N_ACCEPTED = [1] * 16
JAX_SERVING_DENSE_COST = [497.8359680175781, 4677.21142578125, 1387.7991943359375, 4286.8583984375, 2436.688720703125, 8236.8115234375, 4287.5263671875, 5999.23974609375, 1898.3323974609375, 14643.66015625, 1947.3194580078125, 4438.849609375, 1344.0675048828125, 25256.34765625, 2780.07275390625, 4366.15185546875]
JAX_SERVING_DENSE_N_ACCEPTED = [25] * 16
JAX_SERVING_DENSE_PIPELINED_COST = [497.8358459472656, 4677.216796875, 1387.811279296875, 4286.857421875, 2436.69677734375, 8236.755859375, 4287.63623046875, 5999.2138671875, 1898.3343505859375, 14643.6572265625, 1947.3251953125, 4438.86474609375, 1344.0794677734375, 25265.060546875, 2780.0341796875, 4365.830078125]
JAX_SERVING_DENSE_PIPELINED_N_ACCEPTED = [25] * 16
JAX_SERVING_BLOCK_TIED_COST = [2469766.5, 1167910.0, 5497668.5, 1979105.5, 1437797.5, 3859910.25, 2446932.25, 2929667.0, 2964644.5, 1209691.75, 3392828.0, 1756157.875, 2060877.5, 2453045.25, 1619466.625, 2442821.25]
JAX_SERVING_BLOCK_TIED_N_ACCEPTED = [1] * 16
JAX_SERVING_BLOCK_COST = [1832392.875, 329100.78125, 929547.9375, 305896.0, 222767.25, 2478431.25, 1046965.75, 883036.6875, 322366.46875, 283120.09375, 461143.625, 1146964.625, 2025473.125, 1105261.375, 397062.6875, 851801.25]
JAX_SERVING_BLOCK_N_ACCEPTED = [3] * 16
JAX_SERVING_DENSE_FREE_RI = {
    1: {110: [-0.7311654090881348, -0.3916631042957306, -0.5585669279098511, 0.3602422773838043, -0.9169741272926331, 0.17141780257225037, -0.5793295502662659, -0.07588446885347366, 0.8115532994270325]},
    2: {74: [0.04980362951755524, -0.9267010688781738, -0.3724851906299591, 0.8290338516235352, 0.2463388442993164, -0.5020159482955933, 0.5569763779640198, -0.28380048274993896, 0.7805348634719849]},
    4: {105: [0.9805328845977783, 0.12053852528333664, -0.1550016701221466, -0.08507683873176575, 0.9722574949264526, 0.21789219975471497, 0.17696602642536163, -0.20046354830265045, 0.963585615158081]},
    8: {76: [-0.9525389671325684, -0.29195064306259155, 0.08622260391712189, 0.3026215434074402, -0.9388590455055237, 0.1642070710659027, 0.03301025927066803, 0.1825065016746521, 0.9826501607894897], 121: [0.06836744397878647, -0.7335444688796997, -0.6761941909790039, 0.41308870911598206, 0.6377637386322021, -0.6500887274742126, 0.9081209897994995, -0.2348831743001938, 0.34662118554115295]},
    9: {88: [-0.07823991030454636, 0.9969177842140198, 0.0057723489589989185, -0.8763245940208435, -0.06601284444332123, -0.47717639803886414, -0.4753247797489166, -0.04239276796579361, 0.8787885308265686]},
    11: {46: [-0.6347568035125732, 0.7644127011299133, 0.11294712126255035, -0.7210410237312317, -0.638502836227417, 0.26909857988357544, 0.27781951427459717, 0.08937261998653412, 0.9564669728279114], 104: [-0.9819464087486267, -0.18473514914512634, 0.040671173483133316, 0.18751201033592224, -0.9789430499076843, 0.08068238943815231, 0.024909870699048042, 0.08685211092233658, 0.9959098100662231]},
}
JAX_SERVING_BLOCK_FREE_RI = {
    0: {55: [-0.34081748127937317, 0.9241893887519836, 0.1723887026309967, -0.859601616859436, -0.23208805918693542, -0.4552151560783386, -0.3806956708431244, -0.3033307194709778, 0.8735337853431702], 423: [0.6087578535079956, 0.7920277118682861, -0.045891255140304565, -0.7932906150817871, 0.6069448590278625, -0.04804142564535141, -0.010196353308856487, 0.06565062701702118, 0.9977904558181763], 479: [-0.9008044004440308, 0.0032201826106756926, 0.4342130720615387, 0.051810745149850845, -0.9920317530632019, 0.11484228074550629, 0.43112319707870483, 0.12594731152057648, 0.893459677696228]},
    1: {16: [-0.7420801520347595, -0.6661396622657776, 0.07466813921928406, 0.6112781167030334, -0.7182239294052124, -0.332405686378479, 0.2750568091869354, -0.2010287046432495, 0.9401760101318359], 588: [-0.9426180124282837, -0.2676445543766022, 0.19959360361099243, 0.299163818359375, -0.9424930214881897, 0.1490236520767212, 0.14823031425476074, 0.20018360018730164, 0.9684804081916809]},
    2: {149: [-0.9238892793655396, 0.33052077889442444, -0.1928333044052124, -0.2952239215373993, -0.936275839805603, -0.19034232199192047, -0.2434573620557785, -0.11892630159854889, 0.9625928401947021]},
    3: {324: [-0.963208794593811, 0.0528922937810421, 0.26349717378616333, 0.025663966313004494, -0.9578601121902466, 0.2860862910747528, 0.2675253748893738, 0.2823234498500824, 0.9212619066238403], 623: [0.24029146134853363, -0.9706931114196777, 0.003909730818122625, 0.9677537083625793, 0.2392461746931076, -0.0788305252790451, 0.07558473199605942, 0.022725926712155342, 0.9968804717063904]},
    4: {221: [-0.020885156467556953, -0.9994143843650818, 0.02710694633424282, 0.9933457970619202, -0.023814579471945763, -0.11268126219511032, 0.11326069384813309, 0.02457321062684059, 0.993261456489563]},
    5: {169: [-0.9639443755149841, -0.24240805208683014, 0.10977146774530411, 0.23337815701961517, -0.9683103561401367, -0.08893804252147675, 0.12785229086875916, -0.06011302024126053, 0.9899699687957764], 286: [0.38046157360076904, -0.9162556529045105, -0.12539944052696228, 0.6757851839065552, 0.36801642179489136, -0.6386538743972778, 0.631318986415863, 0.15824012458324432, 0.7592077851295471], 378: [0.873508870601654, 0.01678359881043434, 0.4865188002586365, 0.10452324151992798, 0.9696306586265564, -0.22111359238624573, -0.47545474767684937, 0.24399714171886444, 0.8452268838882446]},
    6: {88: [0.39010825753211975, 0.9190965890884399, -0.05547013878822327, -0.9144547581672668, 0.3796863853931427, -0.14003832638263702, -0.10764727741479874, 0.10535507649183273, 0.9885908961296082], 622: [0.8472141027450562, -0.5310251116752625, 0.015516330488026142, 0.530964732170105, 0.8454350233078003, -0.05758874863386154, 0.01746297813951969, 0.057028498500585556, 0.9982199668884277]},
    7: {73: [-0.9474483728408813, 0.2530808448791504, -0.19568271934986115, -0.3126169741153717, -0.8622982501983643, 0.39838695526123047, -0.06791284680366516, 0.43862485885620117, 0.8961004614830017], 241: [0.5294462442398071, 0.8482831716537476, 0.01014162227511406, -0.8482865691184998, 0.5295112729072571, -0.005286578554660082, -0.009854275733232498, -0.005804041400551796, 0.9999348521232605], 324: [0.8732786774635315, 0.4524345099925995, -0.18079674243927002, -0.48295700550079346, 0.8528186678886414, -0.19862747192382812, 0.0643211305141449, 0.2607741355895996, 0.9632548093795776], 445: [-0.9901627898216248, 0.1043345257639885, 0.09323447197675705, -0.09451190382242203, -0.9900559782981873, 0.10419627279043198, 0.10317879915237427, 0.09435933828353882, 0.9901771545410156]},
    8: {290: [0.5533152222633362, 0.826945424079895, -0.10001731663942337, -0.8099411725997925, 0.5621640086174011, 0.16723184287548065, 0.19451794028282166, -0.011523762717843056, 0.9808313250541687], 315: [0.5213955640792847, 0.8523166179656982, 0.041270602494478226, -0.8527995944023132, 0.5221519470214844, -0.00951413530856371, -0.029658587649464607, -0.030234992504119873, 0.9991027116775513], 439: [-0.40250229835510254, 0.913586437702179, 0.0578974187374115, -0.6168472170829773, -0.22394788265228271, -0.7545506954193115, -0.6763812303543091, -0.3394221067428589, 0.6536827087402344], 455: [0.9463832378387451, -0.01865590736269951, -0.32250598073005676, 0.006265905220061541, 0.9992034435272217, -0.03941391408443451, 0.3229846656322479, 0.035279907286167145, 0.9457462430000305], 643: [-0.9465146064758301, -0.0005961097776889801, 0.32265955209732056, -0.048713430762290955, -0.9882720112800598, -0.14472518861293793, 0.3189617991447449, -0.15270237624645233, 0.9353850483894348]},
    9: {0: [0.9653910994529724, -0.20009468495845795, -0.16727706789970398, 0.21358643472194672, 0.9746372699737549, 0.06680282950401306, 0.1496676355600357, -0.1002189889550209, 0.9836440086364746], 433: [0.7867820262908936, -0.5853859782218933, -0.1956971287727356, 0.5355523824691772, 0.8050677180290222, -0.2550484836101532, 0.30685126781463623, 0.09586147218942642, 0.9469174742698669], 556: [-0.8791443109512329, 0.0002075263619190082, 0.4765557050704956, 0.05023758485913277, -0.9943877458572388, 0.0931108221411705, 0.47390058636665344, 0.1057986319065094, 0.8741999864578247]},
    10: {74: [-0.9369387030601501, -0.17525464296340942, -0.3023763597011566, 0.326057493686676, -0.1268383413553238, -0.9368022084236145, 0.1258259117603302, -0.9763185977935791, 0.17598295211791992], 176: [-0.02343299426138401, -0.9993105530738831, -0.02879866026341915, 0.9995838403701782, -0.023904917761683464, 0.016152719035744667, -0.0168299600481987, -0.02840816043317318, 0.9994547367095947], 221: [0.5397629141807556, -0.7979899644851685, 0.2680819034576416, 0.8142720460891724, 0.5757164359092712, 0.07423924654722214, -0.21358127892017365, 0.1782200187444687, 0.9605314135551453], 257: [-0.9853662848472595, 0.022431448101997375, 0.16896754503250122, -0.01647145114839077, -0.9991943836212158, 0.036592915654182434, 0.1696522980928421, 0.03327450156211853, 0.9849419593811035], 353: [-0.8773869872093201, 0.46771904826164246, 0.10691535472869873, -0.47874775528907776, -0.8681126236915588, -0.13107693195343018, 0.031507425010204315, -0.16619065403938293, 0.9855901002883911], 420: [0.9690841436386108, -0.23724766075611115, -0.06774816662073135, 0.2400406450033188, 0.970077395439148, 0.036474645137786865, 0.05706743150949478, -0.05160946771502495, 0.9970353245735168], 439: [0.9992034435272217, 0.03353183716535568, 0.021640580147504807, -0.033780016005039215, 0.9993665814399719, 0.011204125359654427, -0.021251367405056953, -0.011926385574042797, 0.9997032284736633], 452: [0.9723442196846008, 0.027717718854546547, -0.23190267384052277, -0.024233471602201462, 0.9995468258857727, 0.017860006541013718, 0.2322928011417389, -0.011746224015951157, 0.9725750684738159], 543: [-0.9991877675056458, 0.04003409668803215, 0.004563197959214449, -0.04027463123202324, -0.9957346320152283, -0.08300921320915222, 0.0012207786785438657, -0.08312571793794632, 0.996537983417511]},
    11: {123: [0.7603111863136292, -0.23721331357955933, 0.6046956181526184, -0.17203520238399506, 0.8241510987281799, 0.5396100282669067, -0.6263632774353027, -0.5143003463745117, 0.5858021974563599]},
    12: {609: [0.43901368975639343, 0.8967333436012268, -0.056001219898462296, -0.8962461948394775, 0.441463440656662, 0.0430450402200222, 0.063322514295578, 0.03129350766539574, 0.9975022673606873]},
    13: {334: [0.445098340511322, -0.8850279450416565, -0.13642936944961548, 0.8108617663383484, 0.3336838185787201, 0.4807894229888916, -0.37998777627944946, -0.3246240019798279, 0.8661572933197021], 659: [-0.9705098271369934, -0.16668729484081268, 0.17414377629756927, 0.1538429856300354, -0.9844399094581604, -0.08491566777229309, 0.1855885237455368, -0.05562068894505501, 0.9810521602630615]},
    14: {245: [0.8474730849266052, 0.3637250065803528, -0.38664382696151733, -0.43380433320999146, 0.8943248987197876, -0.10953037440776825, 0.30594637989997864, 0.2605520486831665, 0.9157015681266785], 326: [0.4287455379962921, 0.8986040353775024, -0.09320998936891556, -0.8870183229446411, 0.4382864236831665, 0.14527173340320587, 0.1713946908712387, 0.020394351333379745, 0.9849914312362671], 425: [-0.41038158535957336, 0.9062619805335999, 0.10137186199426651, -0.9107701182365417, -0.4128924310207367, 0.004197244998067617, 0.04565960168838501, -0.09060393273830414, 0.9948397874832153]},
    15: {229: [0.8280431032180786, 0.21674710512161255, -0.5170738101005554, -0.28533992171287537, 0.9567962288856506, -0.05587422102689743, 0.482623815536499, 0.19380813837051392, 0.8541151285171509], 289: [0.9991276264190674, 0.01966550573706627, 0.03683915734291077, -0.020674537867307663, 0.999415934085846, 0.027211738750338554, -0.036282651126384735, -0.027949515730142593, 0.9989505410194397]},
}

# Bundle adjustment (phase 19): tests/test_worldmap_ba.py's scene at 8
# keyframes x 1,000 points (harness/ba_scene.py; dim 3,048, 8,000
# observations, 0.5 px noise, the first two poses fixed), 20 iterations.
# JAX package, CPU (tests/test_torch_bundle_adjustment.py run as a script).
# The port on the CPU (``--port``): the same final cost, the mean point error
# 1.2e-4 relative from JAX's (points within 4.2e-7 m), but 6 accepted
# iterations against JAX's 4: the LM stops on the noise floor, where an
# accept is the rounding's, so n_accepted is not held. Limits: ten times
# that spread, the cost at least 1e-4.
BA_SCENE = dict(n_pts=1000, n_kf=8, noise_px=0.5)
BA_ITERATIONS = 20
JAX_BA_FINAL_COST = 3220.419921875
JAX_BA_N_ACCEPTED = 4
JAX_BA_MEAN_POINT_ERROR_M = 0.0005795396337575913
BA_COST_RTOL = 1e-4
BA_POINT_RTOL = 1e-3
# Pose-only on the scene's first keyframe, 1,000 points with the first 50
# moved +80 px; the port on the CPU: JAX's mask, the pose within 6.2e-8.
POSE_ONLY_OUTLIERS = 50
JAX_POSE_ONLY_OUTLIERS = list(range(50))
JAX_POSE_ONLY_R = [[0.9884563684463501, -0.0004261077265255153, 0.15150481462478638],
                   [-1.6750476561355754e-08, 0.9999960064888, 0.0028123219963163137],
                   [-0.1515054851770401, -0.0027798728551715612, 0.9884524941444397]]
JAX_POSE_ONLY_T = [-0.09999996423721313, 4.697230338024383e-08, -4.260858332827411e-08]
# Local BA on keyframe 1 of the scene's map, one observation moved +50 px.
LOCAL_BA_ITERATIONS = 10
JAX_LOCAL_BA = (8000, 1)

# parallel/ (phase 20): the JAX package's scaled pair (bench.py:889-950,
# virtual_scaling_check(n=16384): harness/scaling.py), 5 LM iterations at
# cg_iters 32, with JAX's rotations pinned at its 66 free vertices
# (JAX_SCALING_FREE_RI: {vertex: R row-major}). JAX package, CPU
# (tests/test_torch_parallel.py run as a script): the unsharded solve
# (solve_pair_distributed) and the halo solve on 2 and 4 virtual devices
# after 1 and 5 iterations, and each plan's boundary count. JAX's
# solve_pair_distributed on 2 or 4 virtual devices departs from its own
# unsharded run (tests/test_torch_parallel.py says how), so the port's
# baseline at world 2 is held to JAX's unsharded value (JAX_SCALING_COST),
# on this pair and on the multihost worker's 5 x 5 problem padded to 26
# points (JAX_TINY_COST). Held to PARALLEL_TIED_RTOL after one iteration
# and FINAL_REL_TOL after 5; the halo solve on one rank to
# HALO_ONE_SHARD_RTOL of the baseline's (the same block step on the
# Morton-permuted pair).
PARALLEL_WORLDS = (2, 4)
PARALLEL_ITERS = (1, 5)
PARALLEL_TIED_RTOL = 1e-3
HALO_ONE_SHARD_RTOL = 1e-5
# One sharded damped solve of the pair's first system (halo at worlds 2
# and 4, the baseline at 2) against the plain PCG on one device: the same
# iteration count and x within this of max|x| (the same arithmetic but for
# the order of the sums).
PCG_SHARDED_RTOL = 1e-4
PARALLEL_TIMEOUT_S = 300
TINY_SIDE = 5
JAX_SCALING_FREE_RI = {
    202: [0.008236086927354336, 0.9999661445617676, -0.0003395498206373304, -0.9432895183563232, 0.007882214151322842, 0.3318779170513153, 0.3318694233894348, -0.0024131741374731064, 0.9433223009109497],
    389: [0.8516618609428406, 0.5141498446464539, -0.10159841924905777, -0.524026095867157, 0.8384736180305481, -0.14952819049358368, 0.008307624608278275, 0.1805877983570099, 0.9835237264633179],
    566: [-0.5943693518638611, -0.8041783571243286, 0.004739902447909117, 0.7880690693855286, -0.581268310546875, 0.20266756415367126, -0.16022615134716034, 0.12419479340314865, 0.9792361259460449],
    575: [-0.10842172801494598, -0.9940935373306274, -0.004778370261192322, 0.9861881136894226, -0.10816243290901184, 0.125435933470726, -0.12521186470985413, 0.00888761691749096, 0.9920902252197266],
    693: [0.4588918089866638, 0.8472672700881958, -0.26750022172927856, -0.770123302936554, 0.22915653884410858, -0.5953128933906555, -0.44308972358703613, 0.479192316532135, 0.7576583623886108],
    1036: [0.9923166632652283, -0.0360269658267498, 0.11836214363574982, 0.03144635260105133, 0.9986908435821533, 0.04034417122602463, -0.11966082453727722, -0.036312323063611984, 0.9921503663063049],
    1169: [0.894534707069397, 0.3272245228290558, -0.30451953411102295, -0.304912269115448, 0.9448410868644714, 0.11959980428218842, 0.32685863971710205, -0.0141343604773283, 0.9449675679206848],
    1365: [-0.9865358471870422, -0.0016675685765221715, 0.16353604197502136, 0.0018010305939242244, -0.999998152256012, 0.0006684694672003388, 0.1635347604751587, 0.0009541777544654906, 0.9865371584892273],
    1565: [0.986578643321991, -0.1194535419344902, -0.11132834851741791, 0.09606929868459702, 0.975927472114563, -0.19579775631427765, 0.13203726708889008, 0.18247447907924652, 0.9743046164512634],
    1750: [0.9591372609138489, -0.1718902736902237, -0.22474305331707, 0.14673256874084473, 0.9813302159309387, -0.12433858960866928, 0.2419201284646988, 0.08628065884113312, 0.9664527177810669],
    1926: [0.9925976991653442, -0.02204463817179203, -0.11943107843399048, 0.02525271661579609, 0.9993579983711243, 0.025414541363716125, 0.11879416555166245, -0.028242478147149086, 0.9925171732902527],
    2132: [-0.6826220154762268, -0.684975802898407, -0.2546272277832031, 0.7294811606407166, -0.659409761428833, -0.18175727128982544, -0.043404530733823776, -0.309817373752594, 0.9498047232627869],
    2389: [-0.7539597749710083, -0.5440495014190674, 0.36817699670791626, 0.32000410556793213, -0.7936365008354187, -0.5174344778060913, 0.5737088322639465, -0.27230679988861084, 0.7724683880805969],
    2465: [-0.989428699016571, 0.11410240083932877, 0.08950549364089966, -0.10406622290611267, -0.9884955883026123, 0.10975572466850281, 0.10099921375513077, 0.09928115457296371, 0.9899203777313232],
    2516: [0.9831298589706421, -0.16783450543880463, 0.07271227240562439, 0.16120676696300507, 0.9828935265541077, 0.08906662464141846, -0.08641716837882996, -0.07584259659051895, 0.9933677911758423],
    3280: [0.991776168346405, -0.018878815695643425, -0.12658482789993286, 0.016532575711607933, 0.9996721148490906, -0.019561421126127243, 0.1269126534461975, 0.017307741567492485, 0.9917629361152649],
    3445: [0.3158717751502991, 0.9472939372062683, 0.05347057059407234, -0.868201732635498, 0.3113098442554474, -0.3864087760448456, -0.3826887607574463, 0.07563235610723495, 0.9207763075828552],
    3937: [-0.8624240756034851, -0.49148446321487427, 0.12111079692840576, 0.5050603747367859, -0.8514637351036072, 0.14115071296691895, 0.03374828025698662, 0.18290001153945923, 0.9825522303581238],
    4449: [-0.8097851872444153, -0.5853698253631592, 0.03987796977162361, 0.5859769582748413, -0.8034452795982361, 0.10539171099662781, -0.029653236269950867, 0.10871211439371109, 0.9936309456825256],
    4584: [0.9603312611579895, 0.21110643446445465, 0.1822022646665573, -0.23784376680850983, 0.961167573928833, 0.13995489478111267, -0.14558161795139313, -0.17773887515068054, 0.973249614238739],
    4788: [-0.973455548286438, -0.19602319598197937, -0.11814980953931808, 0.19910398125648499, -0.9798675179481506, -0.014745783060789108, -0.1128806620836258, -0.03787834569811821, 0.9928863644599915],
    5353: [0.99629807472229, 0.006333081983029842, -0.08573035150766373, -0.01597285456955433, 0.9935536980628967, -0.11223162710666656, 0.08446695655584335, 0.11318551748991013, 0.9899769425392151],
    5545: [0.8051074147224426, 0.04398106783628464, 0.5914957523345947, -0.4731816351413727, 0.6489254832267761, 0.5958143472671509, -0.35763227939605713, -0.7595797181129456, 0.5432658791542053],
    5790: [-0.8374955654144287, 0.13732661306858063, -0.528907060623169, -0.039248090237379074, -0.9805238842964172, -0.19243821501731873, -0.5450329780578613, -0.14040760695934296, 0.8265743851661682],
    6035: [-0.9917668104171753, -0.11159699410200119, 0.06280510872602463, 0.10950616747140884, -0.9933405518531799, -0.0358114056289196, 0.06638339161872864, -0.02863924205303192, 0.9973829984664917],
    6123: [-0.9874252080917358, -0.11580438166856766, -0.10761570185422897, 0.1214790865778923, -0.9914451241493225, -0.047742024064064026, -0.10116645693778992, -0.06021493300795555, 0.9930455684661865],
    6217: [0.007080720737576485, -0.9980356097221375, -0.06225203350186348, 0.9759871959686279, 0.02045099064707756, -0.21686610579490662, 0.2177133858203888, -0.059221651405096054, 0.9742143154144287],
    6432: [-0.649242103099823, -0.3561178743839264, 0.6720600128173828, -0.09868970513343811, -0.8366993069648743, -0.5386974215507507, 0.7541520595550537, -0.4160704016685486, 0.5080753564834595],
    6501: [0.13570325076580048, 0.9836241006851196, 0.11861098557710648, -0.9359037280082703, 0.08798936754465103, 0.34109023213386536, 0.32506799697875977, -0.15729564428329468, 0.9325175285339355],
    6504: [-0.9516705274581909, -0.30020958185195923, -0.06478925794363022, 0.3039098381996155, -0.9509541988372803, -0.057666514068841934, -0.04429960623383522, -0.0745697170495987, 0.9962313771247864],
    6528: [-0.13801902532577515, -0.99042147397995, -0.003986391704529524, 0.9900962114334106, -0.1380758434534073, 0.025387993082404137, -0.02569517493247986, -0.00044292278471402824, 0.9996697902679443],
    6570: [-0.8540119528770447, -0.5155956149101257, -0.06946023553609848, 0.5144333839416504, -0.8568125367164612, 0.03507747873663902, -0.07760017365217209, -0.00577603280544281, 0.9969677925109863],
    7158: [-0.09648681432008743, 0.9923999905586243, -0.07636938244104385, -0.9777824878692627, -0.10885141044855118, -0.17914386093616486, -0.1860952377319336, 0.05738763138651848, 0.9808541536331177],
    7551: [0.9672842621803284, -0.1937437206506729, 0.16378270089626312, 0.19123686850070953, 0.9810514450073242, 0.031091222539544106, -0.1667029708623886, 0.0012472872622311115, 0.9860064387321472],
    8055: [-0.45454466342926025, 0.8905733823776245, -0.01637905463576317, -0.8892865180969238, -0.45477867126464844, -0.048435620963573456, -0.05058415234088898, -0.007450428791344166, 0.998691976070404],
    8099: [-0.6889503598213196, -0.7248021364212036, -0.0030174062121659517, 0.7223058938980103, -0.6869112849235535, 0.08016612380743027, -0.060177382081747055, 0.05305099859833717, 0.9967768788337708],
    8365: [-0.9564476013183594, -0.22660177946090698, 0.18401117622852325, 0.2446177452802658, -0.9661744832992554, 0.08166433870792389, 0.1592819094657898, 0.12311995029449463, 0.9795259237289429],
    9049: [-0.9568002223968506, 0.22304241359233856, -0.18650788068771362, -0.26848554611206055, -0.9239689111709595, 0.2723904252052307, -0.11157291382551193, 0.3106980621814728, 0.9439375400543213],
    9175: [0.9805794358253479, -0.11938335746526718, 0.15560032427310944, 0.11031322926282883, 0.991722583770752, 0.06570850312709808, -0.16215695440769196, -0.04726744815707207, 0.9856322407722473],
    9299: [-0.9943252205848694, -0.09086918085813522, 0.055321767926216125, 0.10202398896217346, -0.9618571996688843, 0.2538158893585205, 0.03014754317700863, 0.2580195963382721, 0.9656692743301392],
    9475: [0.9163326025009155, -0.008862795308232307, -0.40031981468200684, 0.006792027037590742, 0.9999550580978394, -0.006591560784727335, 0.4003604054450989, 0.003320873947814107, 0.9163515567779541],
    9487: [0.5983086228370667, 0.7921512722969055, -0.12051016092300415, -0.759103536605835, 0.6085230112075806, 0.23121733963489532, 0.256492555141449, -0.046859677881002426, 0.9654095768928528],
    9770: [0.9807153344154358, -0.19543856382369995, 0.0010766336927190423, 0.1954377293586731, 0.9807159304618835, 0.0008089671027846634, -0.0012140213511884212, -0.000582851585932076, 0.9999991059303284],
    9935: [0.6678119897842407, 0.743020236492157, 0.04413799196481705, -0.7354838252067566, 0.6678289771080017, -0.11431626975536346, -0.1144162192940712, 0.04387892037630081, 0.9924635291099548],
    10370: [-0.3651007115840912, 0.0009986653458327055, 0.9309676289558411, -0.007099579554051161, -0.9999733567237854, -0.0017116125673055649, 0.9309412240982056, -0.007234454620629549, 0.36509791016578674],
    10475: [0.00839997548609972, 0.9793869256973267, 0.20181816816329956, -0.9970217347145081, -0.007269847672432661, 0.07677663862705231, 0.07666130363941193, -0.20186202228069305, 0.9764090776443481],
    10622: [-0.9704812169075012, 0.11648209393024445, 0.21118229627609253, -0.17744965851306915, -0.9378766417503357, -0.29815876483917236, 0.16333319246768951, -0.3268316984176636, 0.93086177110672],
    11142: [-0.8768650889396667, -0.39855048060417175, -0.2688218653202057, 0.31342366337776184, -0.8979542851448059, 0.30893999338150024, -0.3645181655883789, 0.18664343655109406, 0.9123000502586365],
    11289: [0.8526697754859924, 0.5053611993789673, 0.1325310915708542, -0.43585720658302307, 0.82794588804245, -0.3528943657875061, -0.28806746006011963, 0.24313776195049286, 0.9262294769287109],
    11319: [0.9915242791175842, -0.09769874811172485, -0.08564268797636032, 0.0924978032708168, 0.9937347173690796, -0.06273410469293594, 0.09123525768518448, 0.054280634969472885, 0.9943488836288452],
    11358: [-0.8956328630447388, -0.1141083762049675, 0.42990827560424805, 0.25125735998153687, -0.9273465275764465, 0.2773059904575348, 0.36703112721443176, 0.35638177394866943, 0.8592326045036316],
    11533: [-0.9623112082481384, 0.038268715143203735, -0.2692447006702423, -0.028856715187430382, -0.9988290071487427, -0.038830600678920746, -0.2704155147075653, -0.029597830027341843, 0.9622885584831238],
    12244: [0.6504004001617432, -0.7063599824905396, 0.2793472707271576, 0.7443993091583252, 0.5195393562316895, -0.4194624722003937, 0.15115949511528015, 0.48076435923576355, 0.8637225031852722],
    12798: [-0.7313899993896484, -0.674192488193512, 0.1026296392083168, 0.6600213050842285, -0.7376642227172852, -0.142208069562912, 0.17158205807209015, -0.03627187758684158, 0.9845017194747925],
    13060: [-0.9371352195739746, 0.026286564767360687, -0.34797507524490356, -0.018524812534451485, -0.9995003342628479, -0.02561478316783905, -0.3484747111797333, -0.01755836047232151, 0.9371537566184998],
    13238: [0.6705851554870605, -0.7068353295326233, 0.22516492009162903, 0.3213232457637787, 0.0031854365952312946, -0.9469641447067261, 0.6686307191848755, 0.7073708772659302, 0.22925877571105957],
    13464: [0.2579245865345001, 0.9480139017105103, 0.18639925122261047, -0.899663507938385, 0.3059979975223541, -0.3114018440246582, -0.3522511422634125, -0.08737841248512268, 0.9318175911903381],
    14021: [0.45216479897499084, 0.8841079473495483, 0.1178991049528122, -0.8604688048362732, 0.3975856304168701, 0.31862032413482666, 0.23481954634189606, -0.24551740288734436, 0.9405215382575989],
    14301: [-0.9939635992050171, -0.04615965113043785, -0.09952740371227264, 0.06832217425107956, -0.9702317714691162, -0.2323405146598816, -0.08584000915288925, -0.23773807287216187, 0.967528760433197],
    14480: [-0.8887030482292175, -0.43563947081565857, -0.14291705191135406, 0.4578479826450348, -0.8596606254577637, -0.22662538290023804, -0.02413340099155903, -0.26683685183525085, 0.9634396433830261],
    14915: [-0.9429594278335571, -0.32974085211753845, -0.04581422358751297, 0.3275672495365143, -0.943555474281311, 0.04902197793126106, -0.05939282849431038, 0.03121824562549591, 0.9977465867996216],
    15701: [0.5926065444946289, -0.7992411851882935, -0.10015449672937393, 0.7816675901412964, 0.5405983924865723, 0.3110455870628357, -0.19445697963237762, -0.2626151442527771, 0.9451030492782593],
    15814: [0.9107654690742493, 0.13273034989833832, -0.3910098373889923, 0.0672752782702446, 0.8865801095962524, 0.4576566219329834, 0.4074064791202545, -0.4431232213973999, 0.7985373735427856],
    15918: [-0.9853736162185669, -0.1317560225725174, -0.10807016491889954, 0.14939366281032562, -0.9730066657066345, -0.17589625716209412, -0.0819777175784111, -0.18946857750415802, 0.97845858335495],
    16177: [0.9750863909721375, 0.010885435156524181, -0.22155851125717163, 0.004534788429737091, 0.9976082444190979, 0.06897260993719101, 0.22177959978580475, -0.06825917959213257, 0.9727045893669128],
    16218: [0.8837022185325623, -0.29265880584716797, -0.3652685880661011, 0.2573942244052887, 0.9556700587272644, -0.14297837018966675, 0.39092013239860535, 0.0323324128985405, 0.9198565483093262],
}
JAX_SCALING_N_BOUNDARY = {2: 492, 4: 1168}
JAX_SCALING_COST = {1: 134073656.0, 5: 77040104.0}
JAX_SCALING_HALO_COST = {(2, 1): 134073648.0, (2, 5): 77039712.0,
                         (4, 1): 134073640.0, (4, 5): 77039680.0}
JAX_TINY_COST = {1: 115.27557373046875, 5: 8.047013282775879}

PEAK_BYTES_PER_S = 3.35e12

SOLVE_KERNELS = ("damped_solve_kernel", "pcg_kernel")
# Kernel 1 repeated on one input: every output bit-identical.
REPEATS = 20
# Idle host time at both ends of a profiled step (device_launches).
PROFILE_MARGIN_S = 0.05


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def make_system(dim, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(dim, dim)).astype(np.float32)
    H = A @ A.T + dim * np.eye(dim, dtype=np.float32)
    d = 10.0 ** rng.uniform(-3, 5, size=dim).astype(np.float32)
    H = (H * d[:, None] * d[None, :]).astype(np.float32)
    g = (rng.normal(size=dim) * d).astype(np.float32)
    return H, g, float(H.diagonal().max()) * 1e-6


def make_ill_conditioned(dim, cond, seed, upper_eta=0.0):
    """H [dim, dim] f32 whose unit-diagonal core has eigenvalues from 1 down
    to 1/cond, plus (``upper_eta`` > 0) a random upper triangle of relative
    size ``upper_eta``, scaled by diagonal factors 1e-3..1e5; g [dim] f32."""
    import math

    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    o = dict(dtype=torch.float64, device="cuda")
    Q, _ = torch.linalg.qr(torch.randn(dim, dim, generator=gen, **o))
    C = (Q * torch.logspace(0, -math.log10(cond), dim, **o)) @ Q.T
    C = 0.5 * (C + C.T)
    if upper_eta:
        C = C + torch.triu(torch.randn(dim, dim, generator=gen, **o), 1) * (upper_eta / math.sqrt(dim))
    c = torch.rsqrt(C.diagonal())
    d = 10.0 ** (8.0 * torch.rand(dim, generator=gen, **o) - 3.0)
    H = (C * (c * d)[:, None] * (c * d)[None, :]).float()
    g = (torch.randn(dim, generator=gen, **o) * d).float()
    return H, g


def chol_call(lib, entry, H, g, lam, *extra):
    """One direct call of kernel 1's C entry point ``entry`` (in ``lib``)
    with a workspace of its own, not counted in ``LAUNCHES``; ``extra``
    pointers go before the stream. Returns x and the workspace's x0."""
    import torch

    n = H.shape[0]
    npad = lib.tids_damped_solve_pad(n)
    o = dict(dtype=torch.float32, device=H.device)
    x = torch.empty(n, **o)
    L = torch.empty(npad * npad, **o)
    Linv = torch.empty(npad * 32, **o)
    vecs = torch.empty(4, npad, **o)  # s, b, y, x0
    lam_t = torch.full((1,), float(lam), **o)
    err = getattr(lib, entry)(
        H.data_ptr(), g.data_ptr(), lam_t.data_ptr(), x.data_ptr(), n, L.data_ptr(),
        Linv.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
        vecs[3].data_ptr(), *extra, torch.cuda.current_stream().cuda_stream,
    )
    check(err == 0, f"direct kernel call {entry} failed: cudaError_t {err}")
    return x, vecs[3, :n]


def kernel_x_and_x0(H, g, lam):
    """The kernel's x and its own unrefined solution x0 (steps 1-4 of
    csrc/damped_cholesky.cu), which stays in the workspace."""
    import torch

    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    x, x0 = chol_call(dc._load(), "tids_damped_solve", H, g, lam)
    torch.cuda.synchronize()
    return x, x0.clone()


def accuracy(H, g, lam):
    """Errors against an f64 solve of the same f32 system (the whole matrix),
    relative to max|x*|: the kernel's x, its unrefined x0 and the plain
    version's x; and the condition number of the equilibrated matrix's
    symmetric part."""
    import torch

    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    A = H.double() + float(lam) * torch.eye(H.shape[0], dtype=torch.float64, device=H.device)
    xs = -torch.linalg.solve(A, g.double())
    s = torch.rsqrt(A.diagonal())
    ev = torch.linalg.eigvalsh(A * s[:, None] * s[None, :])  # reads the lower triangle
    x, x0 = kernel_x_and_x0(H, g, lam)
    check(torch.equal(x, dc.damped_solve_cuda(H, g, lam)), "direct kernel call differs from the wrapper")
    xp = dc.solve_damped_cholesky_plain(H, g, float(lam))
    scale = float(xs.abs().max())
    err = lambda v: float((v.double() - xs).abs().max()) / scale
    return dict(err_x=err(x), err_x0=err(x0), err_plain=err(xp),
                cond=float(ev.max() / ev.min()))


def time_ms(fn, reps=30, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps=200):
    """Mean host time (us) of one call of ``fn``, over ``reps`` calls in a
    row with no synchronize between them (the card runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def device_ms(fn, kernel, reps=20):
    """Mean device time (ms) of the CUDA kernel named ``kernel`` per call of
    ``fn``, from ``torch.profiler`` (CUPTI kernel records): unlike CUDA
    events around a call, it leaves out the host's enqueue time, which is
    not small beside a kernel of tens of microseconds."""
    ms = sum(count * per for name, (count, per) in device_launches(fn, reps).items() if kernel in name)
    check(ms > 0, f"the profiler saw no {kernel} time")
    return ms / reps


def device_launches(fn, reps=20, tries=5):
    """CUDA kernel launches over ``reps`` calls of ``fn`` and their mean
    device time (ms) per launch, by kernel name, from ``torch.profiler``.
    The calls are recorded in the active step of a schedule whose warm-up
    step runs them once before, with PROFILE_MARGIN_S of idle host time at
    both ends of each step: kernels near the edges of the window went
    unrecorded (read: 13 of 20 solves at dim 1448 without the warm-up step,
    19 of 20 at 4096 without the margins). Records are still lost at times
    (read: 8 of 20 launches of an 18 us kernel after 400 s of other phases;
    once all of them), so a count that is zero or not a whole multiple of
    ``reps`` (identical calls launch alike) is profiled again, up to
    ``tries`` times. A lost record can only lower a count, so this hides no
    extra launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                time.sleep(PROFILE_MARGIN_S)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
                prof.step()
        seen = {ev.key: (ev.count, ev.self_device_time_total / ev.count / 1e3)
                for ev in prof.key_averages() if ev.self_device_time_total > 0}
        total = sum(count for count, _ in seen.values())
        if total and total % reps == 0:
            break
        log(f"[profiler] {total} launch records for {reps} identical calls (attempt {attempt + 1}): profiling again")
    return seen


def bound(dim):
    """Least time for one damped solve: the factorization's dim^3/3 flops plus
    the four triangular solves and the refinement matvec (~10 dim^2), against
    H, g and x moved once."""
    ops = dim**3 / 3.0 + 10.0 * dim**2
    nbytes = 4.0 * (dim * dim + 2 * dim + 1)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_case(label, Hc, gc, lam, rel_tol=KERNEL_REL_TOL):
    """The kernel against the plain version on one system (relative to
    max|x|, held below ``rel_tol`` unless it is None); non-PD check; times of
    the kernel, the plain version and the library call."""
    import torch

    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    dim = Hc.shape[0]
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device="cuda")
    x = dc.damped_solve_cuda(Hc, gc, lam_t)
    torch.cuda.synchronize()
    xp = dc.solve_damped_cholesky_plain(Hc, gc, lam_t)
    err = float((x - xp).abs().max())
    rel = err / float(xp.abs().max())
    check(bool(torch.isfinite(x).all()), f"kernel output not finite ({label})")
    check(rel_tol is None or rel < rel_tol, f"kernel vs plain relative error {rel:.3e} ({label})")
    solve = lambda: dc.damped_solve_cuda(Hc, gc, lam_t)
    for _ in range(REPEATS):
        check(torch.equal(solve(), x), f"a repeated call is not bit-identical ({label}, dim {dim})")
    launches = device_launches(solve, REPEATS)
    seen = sum(count for count, _ in launches.values())
    check(seen == REPEATS and all("damped_solve_kernel" in name for name in launches),
          f"{REPEATS} solves launched {launches} ({label}, dim {dim}), not one damped_solve_kernel each")
    device_ms = sum(ms for _, ms in launches.values())

    Hbad = Hc.clone()
    Hbad[dim // 3, dim // 3] = -float(Hc[dim // 3, dim // 3]) - 1.0
    xbad = dc.damped_solve_cuda(Hbad, gc, 0.0)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(xbad).all()), f"non-PD input gave finite output ({label})")

    A = Hc + lam_t * torch.eye(dim, device="cuda")

    def library():
        Lf, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(-gc[:, None], Lf)

    ms = time_ms(solve)
    plain_ms = time_ms(lambda: dc.solve_damped_cholesky_plain(Hc, gc, lam_t))
    library_ms = time_ms(library)
    bound_ms, bound_by = bound(dim)
    log(f"[kernel] {label} dim={dim} grid={dc._load().tids_damped_solve_grid(dim)} blocks "
        f"max_abs_err={err:.3e} rel_err={rel:.3e} non_pd=non-finite repeats={REPEATS} bit-identical "
        f"launches_per_solve={seen / REPEATS:g} ms={ms:.4f} device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
    return dict(max_abs_err=err, rel_err=rel, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def kernel_phase():
    """Synthetic well-conditioned systems at the main paths' dims, then the main
    path's own first system and a synthetic one at about the same condition
    number, held to an f64 solve; returns the synthetic dim-1448 row."""
    import torch

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import lm

    rows = {}
    for dim in (6, 377, 728, 746, 1448, 2591, 3048, 4096):
        H, g, lam = make_system(dim, seed=dim)
        rows[dim] = kernel_case("synthetic", torch.as_tensor(H, device="cuda"),
                                torch.as_tensor(g, device="cuda"), lam)

    data, state, hyper = _first_problem(240)
    spec = deformable.MODELS[sc.sweep_config().opt_model]
    H, g = deformable.build_system("KB8", data, hyper, state, spec)
    lam = float(lm.TAU * H.diagonal().max())
    kernel_case("main path", H, g, lam, rel_tol=None)
    hold_accuracy("main path", H, g, lam)
    H, g = make_ill_conditioned(1448, ILL_COND, seed=7)
    hold_accuracy("synthetic", H, g, 0.0)
    return rows[1448]


def hold_accuracy(label, H, g, lam):
    """The kernel's error against an f64 solve at most ACCURACY_FACTOR times
    the plain version's."""
    acc = accuracy(H, g, lam)
    log(f"[accuracy] {label} dim={H.shape[0]} cond={acc['cond']:.3e} error vs f64: "
        f"kernel_x={acc['err_x']:.3e} kernel_x0={acc['err_x0']:.3e} plain={acc['err_plain']:.3e}")
    check(acc["err_x"] <= ACCURACY_FACTOR * acc["err_plain"],
          f"kernel error {acc['err_x']:.3e} > {ACCURACY_FACTOR} x plain {acc['err_plain']:.3e} ({label})")


def refinement_phase():
    """The kernel's refined x below REFINE_LIMIT, its own unrefined x0 above
    it: a kernel without the refinement step, or with a residual that does
    not read the whole matrix, fails."""
    H, g = make_ill_conditioned(1448, REFINE_COND, seed=7, upper_eta=REFINE_UPPER_ETA)
    acc = accuracy(H, g, 0.0)
    log(f"[refine] dim=1448 cond={acc['cond']:.3e} upper_eta={REFINE_UPPER_ETA:.0e} error vs f64: "
        f"kernel_x={acc['err_x']:.3e} kernel_x0={acc['err_x0']:.3e} plain={acc['err_plain']:.3e} "
        f"limit={REFINE_LIMIT:.0e}")
    check(acc["err_x"] < REFINE_LIMIT, f"refined error {acc['err_x']:.3e} >= {REFINE_LIMIT:.0e}")
    check(acc["err_x0"] > REFINE_LIMIT,
          f"unrefined error {acc['err_x0']:.3e} <= {REFINE_LIMIT:.0e}: the case cannot tell")


def run_pipeline(device, num_points, rounds, evals, iters, seed=0, overrides=None, workdir=None):
    """The simulation on the sweep condition's settings with ``overrides``
    replacing Config fields, in ``workdir`` (the journal, and ``viz/``) or
    a temporary directory."""
    import dataclasses

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.pipeline.simulation import SimulationPipeline

    cfg = sc.sweep_config(n_optimizations=rounds, nlopt_evals=evals, n_opt_iterations=iters)
    cfg = dataclasses.replace(cfg, **(overrides or {}))
    with tempfile.TemporaryDirectory() as tmp:
        work = workdir or tmp
        of, mf = sc.write_fixture(os.path.join(work, "fixture"), num_points=num_points, seed=seed)
        pipe = SimulationPipeline(cfg, seed=seed, mesh_backend=sc.MESH_BACKEND, device=device)
        return pipe.run(of, mf, journal_path=os.path.join(work, "Experiment.txt"))


def main_path_phase():
    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    dc.LAUNCHES = 0
    dc.LAUNCHES_BY_DIM.clear()
    t0 = time.perf_counter()
    res = run_pipeline("cuda", 240, 5, 8, 25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dc.LAUNCHES
    st = res.stats
    log(f"[main] n_valid={int(res.valid.sum())} rounds={res.rounds} weights={res.weights.tolist()} "
        f"rigid_accepted={res.rigid_accepted}")
    log(f"[main] initial_av_error_m={res.initial.av_error!r} final_av_error_m={res.final.av_error!r} "
        f"(JAX CPU {JAX_INITIAL_AV_ERROR_M!r} -> {JAX_FINAL_AV_ERROR_M!r})")
    log(f"[main] inner_solves={st.inner_solves} lm_iterations={st.lm_iterations} "
        f"lm_solves={st.lm_solves} kernel_launches={launches} "
        f"by_dim={dict(sorted(dc.LAUNCHES_BY_DIM.items()))} wall_s={wall:.3f}")
    check(launches > 0, "the main path did not launch the damped-Cholesky kernel")
    check(launches == st.lm_solves, f"launches {launches} != LM solves {st.lm_solves}")
    check(int(res.valid.sum()) == JAX_N_VALID, "n_valid differs from the JAX run")
    check(np.isfinite(res.final.av_error), "final error not finite")
    check(abs(res.initial.av_error - JAX_INITIAL_AV_ERROR_M) < INITIAL_TOL_M,
          "initial av error differs from the JAX CPU value")
    check(abs(res.final.av_error - JAX_FINAL_AV_ERROR_M) < FINAL_REL_TOL * JAX_FINAL_AV_ERROR_M,
          "final av error outside the tolerance of the JAX CPU value")
    return launches


def _first_problem(num_points, device="cuda"):
    """The first inner solve of the simulation at ``num_points``: the
    pipeline's own steps up to the first ``solve_pair`` (arap weight 1e4,
    the search's z0)."""
    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.pipeline.simulation import SimulationPipeline

    cfg = sc.sweep_config()
    pipe = SimulationPipeline(cfg, seed=0, mesh_backend=sc.MESH_BACKEND, device=device)
    orig, moved = sc.sweep_points(num_points, 0)
    rng = np.random.default_rng(0)
    T1w, T2w = pipe._poses(moved[0])
    kp1, kp2, d1, d2 = pipe._simulate_observations(orig, moved, T1w, T2w, rng)
    p1, p2, valid, _, _ = pipe._triangulate(kp1, kp2, T1w, T2w, d1, d2)
    s1, se1 = pipe._initial_depth_scale(p1, T1w, d1, valid)
    s2, se2 = pipe._initial_depth_scale(p2, T2w, d2, valid)
    data = deformable.make_pair_data(
        kp1, kp2, d1, d2, valid, cfg.kb8_params, T1w, T2w, p1.cpu().numpy(), p2.cpu().numpy(),
        mesh_backend=sc.MESH_BACKEND, scale_priors=(s1, se1**-2, s2, se2**-2), device=device,
    )
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    state = deformable.PairState(p1=p1, p2=p2, s1=f(s1), s2=f(s2), Rg=torch.eye(3, device=device),
                                 tg=torch.zeros(3, device=device))
    hyper = deformable.Hyper(rep_w=f(1.0), arap_w=f(1e4), depth_sigma=f(0.003), global_w=f(1.0),
                             alpha=f(1.0), beta=f(1.0))
    return data, state, hyper


@contextlib.contextmanager
def synchronized_split(targets):
    """While open, every call of the functions ``targets`` names ((module,
    attribute, key) triples) runs between synchronizes and adds its host
    time to the yielded dict under its key; the functions are restored on
    exit."""
    import torch

    spent = {key: 0.0 for _, _, key in targets}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return wrapper

    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for mod, name, key in targets:
        setattr(mod, name, timed(getattr(mod, name), key))
    try:
        yield spent
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def split_phase(num_points):
    """Where the time of the simulation goes at ``num_points``.

    (a) One round with a synchronize around every assembly
    (``build_system``, ``build_block_system``, ``build_system_rigid``),
    damped solve (kernel 1 or kernel 2) and cost evaluation of the LM loop,
    timed on the host clock; the rest of the wall time is the host loop
    (search decisions, meshing, metrics, journal).
    (b) ``torch.profiler`` (device activity only) over one inner solve of 25
    LM iterations: device time of the solve kernels and of all other
    kernels, and the device's idle share of that window.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import block_system, deformable, rigid
    from triangulation_in_deformable_scenes_torch.ops import block_pcg, lm

    targets = [(deformable, "build_system", "assembly"), (block_system, "build_block_system", "assembly"),
               (rigid, "build_system_rigid", "assembly"), (lm, "solve_damped_cholesky", "solve"),
               (block_pcg, "pcg_block_system", "solve"), (deformable, "robust_cost", "cost"),
               (rigid, "robust_cost_rigid", "cost")]
    with synchronized_split(targets) as spent:
        t0 = time.perf_counter()
        res = run_pipeline("cuda", num_points, 1, 8, 25)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host = wall - sum(spent.values())
    log(f"[split] {num_points} points, one round, synchronized: wall_s={wall:.3f} "
        f"assembly_s={spent['assembly']:.3f} solve_s={spent['solve']:.3f} cost_s={spent['cost']:.3f} "
        f"host_loop_s={host:.3f} lm_solves={res.stats.lm_solves} rigid_solves={res.stats.rigid_solves}")

    data, state, hyper = _first_problem(num_points)
    spec = deformable.MODELS[sc.sweep_config().opt_model]
    deformable.solve_pair("KB8", data, hyper, state, 2, spec)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = deformable.solve_pair("KB8", data, hyper, state, 25, spec)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    solve_us = other_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us <= 0:
            continue
        if any(k in ev.key for k in SOLVE_KERNELS):
            solve_us += dev_us
        else:
            other_us += dev_us
    busy = (solve_us + other_us) / 1e6
    log(f"[split] {num_points} points, one inner solve (25 LM iterations, {r.n_solves} solves), profiled: "
        f"window_s={window:.3f} solve_device_s={solve_us / 1e6:.4f} other_device_s={other_us / 1e6:.4f} "
        f"device_idle_share={max(0.0, 1.0 - busy / window):.3f}")
    check(solve_us > 0, "the profiler saw no solve-kernel time")


def cross_device_phase():
    import numpy as np

    r_gpu = run_pipeline("cuda", **REDUCED)
    r_cpu = run_pipeline("cpu", **REDUCED)
    d_init = abs(r_gpu.initial.av_error - r_cpu.initial.av_error)
    d_final = abs(r_gpu.final.av_error - r_cpu.final.av_error)
    log(f"[cross] cuda {r_gpu.initial.av_error!r}->{r_gpu.final.av_error!r} "
        f"cpu {r_cpu.initial.av_error!r}->{r_cpu.final.av_error!r} rounds {r_gpu.rounds}/{r_cpu.rounds} "
        f"weights {r_gpu.weights.tolist()}/{r_cpu.weights.tolist()} d_final_m={d_final:.3e}")
    check(int(r_gpu.valid.sum()) == int(r_cpu.valid.sum()), "n_valid differs cuda vs cpu")
    check(d_init < INITIAL_TOL_M, "initial av error differs cuda vs cpu")
    check(r_gpu.rounds == r_cpu.rounds, "rounds differ cuda vs cpu")
    check(np.allclose(r_gpu.weights, r_cpu.weights, rtol=CROSS_WEIGHTS_RTOL, atol=0.0),
          "weights differ cuda vs cpu")
    check(np.isfinite(r_gpu.final.av_error), "final error not finite on cuda")
    check(d_final < CROSS_FINAL_TOL_M, "final av error differs cuda vs cpu")


def _block_problem(num_points):
    """The first block system of the large-N path at ``num_points``: (sys,
    nbr, b = -g, lam) with lam the LM loop's first damping."""
    import torch

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import block_system, deformable
    from triangulation_in_deformable_scenes_torch.ops import lm

    data, state, hyper = _first_problem(num_points)
    spec = deformable.MODELS[sc.sweep_config().opt_model]
    sys_ = block_system.build_block_system("KB8", data, hyper, state, spec)
    b = -block_system.flat_gradient(sys_)
    lam = lm.TAU * torch.max(block_system.diag_of(sys_))
    return sys_, data.nbr, b, lam


def pcg_bound(n, K, iters):
    """Least time of one PCG solve: its inputs (D, Bt, C, Hg, nbr, b) read
    once and x written once, against the operations of ``iters`` iterations
    (per point: the Bt, D and both C products, the preconditioner, three
    dots and three axpys) plus the prologue's inverses. Also returned: the
    time to stream the operator of bench.py:553 plus Dinv once per
    iteration, as if no cache held it."""
    dim = 6 * n + 8
    nbytes = 4.0 * (n * 36 + n * K * 36 + n * 48 + 64 + 2 * dim + 1) + 8.0 * n * K
    ops = iters * n * (72.0 * K + 408.0) + n * 400.0
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    stream = iters * 4.0 * (n * K * 36 + n * 36 + n * 48 * 2 + n * K * 6 + 4 * dim + n * 36)
    return (max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"),
            stream / PEAK_BYTES_PER_S * 1e3)


PCG_PHASES = ("prologue", "matvec", "partial_sums", "grid_sync", "serial", "rz_pass")


def pcg_phases(sys_, nbr, b, lam, iters, rtol, reps=20):
    """Kernel 2's one launch split into phases by the SM clock that thread 0
    of block 0 keeps (``tids_pcg_solve_timed``), converted to ms by the
    launch's globaltimer span: the median of each phase over ``reps`` solves,
    their total, and the iterations."""
    import torch

    from triangulation_in_deformable_scenes_torch.ops import _nvcc
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    lib = block_pcg._load()
    sys_ = type(sys_)(*(t.contiguous() for t in sys_))
    n, K = nbr.shape
    x = torch.empty_like(b)
    ws = torch.zeros(int(lib.tids_pcg_workspace_floats(n, K)), dtype=torch.float32, device=b.device)
    k = torch.empty(1, dtype=torch.int32, device=b.device)
    total = torch.zeros(1, dtype=torch.int64, device=b.device)
    stamps = torch.zeros(16, dtype=torch.int64, device=b.device)
    lam_t = _nvcc.lam_tensor(lam, b)
    rows = []
    for _ in range(reps + 1):
        err = lib.tids_pcg_solve_timed(
            sys_.D.data_ptr(), sys_.Bt.data_ptr(), sys_.C.data_ptr(), sys_.Hg.data_ptr(), nbr.data_ptr(),
            b.data_ptr(), lam_t.data_ptr(), x.data_ptr(), n, K, int(iters), float(rtol) * float(rtol),
            ws.data_ptr(), k.data_ptr(), total.data_ptr(), stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"tids_pcg_solve_timed failed: cudaError_t {err}")
        st = stamps.cpu().tolist()
        ns_per_cycle = (st[9] - st[8]) / max(st[11] - st[10], 1)
        rows.append([v * ns_per_cycle / 1e6 for v in st[: len(PCG_PHASES)]] + [(st[9] - st[8]) / 1e6])
    rows = rows[1:]
    out = {name: statistics.median(r[i] for r in rows) for i, name in enumerate(PCG_PHASES)}
    out["total"] = statistics.median(r[-1] for r in rows)
    return out, int(k)


def pcg_case(num_points):
    """Kernel 2 against the plain version on the large-N path's first
    system at ``num_points``; returns its row."""
    return pcg_check(f"{num_points} points", *_block_problem(num_points))


def serving_pcg_case():
    """Kernel 2 against the plain version on the serving block branch's own
    system: pair 0 of the 680-point fixture (JAX's rotations pinned) at its
    first step and the LM loop's first damping; returns its row."""
    import torch

    from triangulation_in_deformable_scenes_torch.harness import serving
    from triangulation_in_deformable_scenes_torch.models import block_system, deformable
    from triangulation_in_deformable_scenes_torch.ops import lm

    fb = serving.serving_batch(serving.BLOCK_POINTS, batch=1, rotations=JAX_SERVING_BLOCK_FREE_RI)
    sys0 = block_system.build_block_system("KB8", fb.datas[0], fb.hyper, fb.states[0], deformable.ModelSpec())
    return pcg_check(f"serving block pair 0, {serving.BLOCK_POINTS} points", sys0, fb.datas[0].nbr,
                     -block_system.flat_gradient(sys0), lm.TAU * torch.max(block_system.diag_of(sys0)))


def pcg_check(label, sys_, nbr, b, lam):
    """Kernel 2 against the plain version on one system: iteration counts,
    error against the plain version and against f64, tight-solve residuals,
    the cap at rtol 0, REPEATS calls bit-identical, one cooperative launch
    per solve; times, phase split and bound. Returns the kernel's row."""
    import torch

    from triangulation_in_deformable_scenes_torch.models import block_system, deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    n, K = nbr.shape
    dim = 6 * n + 8
    its, rtol = deformable.CG_ITERS, deformable.CG_RTOL
    x, k = block_pcg.pcg_block_system_cuda(sys_, nbr, b, lam, its, rtol)
    torch.cuda.synchronize()
    xp, kp = block_pcg.pcg_block_system_plain(sys_, nbr, b, lam, its, rtol)
    k = int(k)
    err = float((x - xp).abs().max())
    rel = err / float(xp.abs().max())
    check(bool(torch.isfinite(x).all()), f"PCG kernel output not finite ({label})")
    check(k == kp, f"PCG kernel took {k} iterations, the plain version {kp} ({label})")
    check(rel < PCG_REL_TOL, f"PCG kernel vs plain relative error {rel:.3e} ({label})")
    sys64 = block_system.BlockSystem(*(a.double() for a in sys_))
    x64, _ = block_pcg.pcg_block_system_plain(sys64, nbr, b.double(), lam.double(), k, 0.0)
    scale = float(x64.abs().max())
    err_k = float((x.double() - x64).abs().max()) / scale
    err_p = float((xp.double() - x64).abs().max()) / scale
    check(err_k <= PCG_ACCURACY_FACTOR * err_p,
          f"PCG kernel error vs f64 {err_k:.3e} > {PCG_ACCURACY_FACTOR} x plain {err_p:.3e} ({label})")
    solve = lambda: block_pcg.pcg_block_system_cuda(sys_, nbr, b, lam, its, rtol)
    for _ in range(REPEATS):
        xr, kr = solve()
        check(torch.equal(xr, x) and int(kr) == k, f"a repeated PCG call is not bit-identical ({label})")

    # Tight solves: the true residual of the plain operator, in f64, for two
    # right-hand sides: -g, and (H + lam I) x* with x* on the 8 global
    # entries only, (diag Hg + lam)^-1/2, which loads the point-to-global
    # coupling as -g does not; the kernel's iterations against the plain
    # loop's.
    xstar = torch.zeros(dim, dtype=torch.float64, device=b.device)
    xstar[6 * n :] = torch.rsqrt(torch.diagonal(sys64.Hg) + lam.double())
    b_global = block_system.block_matvec(sys64, nbr, xstar, lam.double()).float()
    tight = {}
    for name, rhs in (("-g", b), ("global", b_global)):
        xt, kt = block_pcg.pcg_block_system_cuda(sys_, nbr, rhs, lam, PCG_TIGHT_CAP, PCG_TIGHT_RTOL)
        _, kpt = block_pcg.pcg_block_system_plain(sys_, nbr, rhs, lam, PCG_TIGHT_CAP, PCG_TIGHT_RTOL)
        res = block_system.block_matvec(sys64, nbr, xt.double(), lam.double()) - rhs.double()
        tight[name] = (int(kt), kpt, float(torch.linalg.norm(res) / torch.linalg.norm(rhs.double())))
        check(tight[name][2] <= 2.0 * PCG_TIGHT_RTOL,
              f"PCG kernel residual {tight[name][2]:.3e} > {2 * PCG_TIGHT_RTOL:.0e} at rtol "
              f"{PCG_TIGHT_RTOL:.0e}, right-hand side {name} ({label})")
    kt = tight["-g"][0]
    _, kc = block_pcg.pcg_block_system_cuda(sys_, nbr, b, lam, PCG_CAP_ITERS, 0.0)
    check(int(kc) == PCG_CAP_ITERS, f"PCG kernel ran {int(kc)} iterations at rtol 0, cap {PCG_CAP_ITERS} ({label})")

    launches = device_launches(solve, REPEATS)
    seen = sum(count for count, _ in launches.values())
    check(seen == REPEATS and all("pcg_kernel" in name for name in launches),
          f"{REPEATS} PCG solves launched {launches} ({label}), not one pcg_kernel each")
    ms = sum(count * per for count, per in launches.values()) / REPEATS
    event_ms = time_ms(solve)
    wrapper_us = host_us(solve)
    plain_ms = time_ms(lambda: block_pcg.pcg_block_system_plain(sys_, nbr, b, lam, its, rtol), reps=10)
    tight_ms = device_ms(
        lambda: block_pcg.pcg_block_system_cuda(sys_, nbr, b, lam, PCG_TIGHT_CAP, PCG_TIGHT_RTOL),
        "pcg_kernel", reps=5)
    path_split, _ = pcg_phases(sys_, nbr, b, lam, its, rtol)
    tight_split, _ = pcg_phases(sys_, nbr, b, lam, PCG_TIGHT_CAP, PCG_TIGHT_RTOL, reps=5)
    per_it = {name: 1e3 * (tight_split[name] - path_split[name]) / max(kt - k, 1) for name in tight_split}
    bound_ms, bound_by, stream_ms = pcg_bound(n, K, k)
    tight_bound_ms, _, tight_stream_ms = pcg_bound(n, K, kt)
    lib = block_pcg._load()
    log(f"[pcg] {label} dim={dim} N={n} K={K} grid={lib.tids_pcg_grid(n, K)} blocks "
        f"resident={lib.tids_pcg_resident(n, K)} iterations={k} (plain {kp}) max_abs_err={err:.3e} "
        f"rel_err={rel:.3e} vs_f64: kernel={err_k:.3e} plain={err_p:.3e} "
        f"tight (kernel iterations, plain iterations, residual): {tight} cap_at_rtol0={int(kc)} "
        f"repeats={REPEATS} bit-identical launches_per_solve={seen / REPEATS:g} "
        f"ms={ms:.4f} (device; {event_ms:.4f} by events around the wrapper, whose host time is "
        f"{wrapper_us:.1f} us) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) stream_bound_ms={stream_ms:.5f} | tight_ms={tight_ms:.4f} "
        f"tight_bound_ms={tight_bound_ms:.5f} tight_stream_bound_ms={tight_stream_ms:.5f} "
        f"us_per_iteration={1e3 * (tight_ms - ms) / max(kt - k, 1):.2f}")
    log(f"[pcg] {label} split of the path's solve (median ms of 20): "
        + " ".join(f"{name}={v:.5f}" for name, v in path_split.items())
        + " | per iteration (us): " + " ".join(f"{name}={v:.3f}" for name, v in per_it.items()))
    return dict(dim=dim, iterations=k, max_abs_err=err, ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, host_us=wrapper_us)


def pcg_stride_case():
    """Kernel 2 beyond the resident limit (the strided kernel: fewer warps
    than points): the 861-point system repeated M times as independent
    copies (global block scaled by M, so the whole stays positive definite),
    with the smallest M that the resident kernel cannot hold."""
    import torch

    from triangulation_in_deformable_scenes_torch.models import block_system
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    sys_, nbr, b, lam = _block_problem(LARGE_POINTS)
    n, K = nbr.shape
    lib = block_pcg._load()
    m = 2
    while lib.tids_pcg_resident(n * m, K) != 0:
        m += 1
    tile = lambda t: t.repeat(m, *([1] * (t.dim() - 1)))
    offs = (torch.arange(m, device=nbr.device) * n).repeat_interleave(n)[:, None]
    nbr_m = torch.where(tile(nbr) < 0, tile(nbr), tile(nbr) + offs)
    big = block_system.BlockSystem(tile(sys_.D), tile(sys_.Bt), tile(sys_.C), sys_.Hg * m, tile(sys_.g_p),
                                   sys_.g_g * m)
    check(lib.tids_pcg_resident(n * m, K) == 0 and lib.tids_pcg_grid(n * m, K) * 8 < n * m,
          "the repeated system is not on the strided kernel")
    return pcg_check(f"{m} x {n} points (strided)", big, nbr_m, -block_system.flat_gradient(big), lam)


def large_main_phase():
    """The simulation at 861 points, full budget; returns the PCG launches."""
    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch.ops import block_pcg
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    total = block_pcg.iterations_total("cuda")
    dc.LAUNCHES = 0
    dc.LAUNCHES_BY_DIM.clear()
    block_pcg.LAUNCHES = 0
    block_pcg.LAUNCHES_BY_DIM.clear()
    total.zero_()
    t0 = time.perf_counter()
    res = run_pipeline("cuda", LARGE_POINTS, 5, 8, 25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pcg, dense, iters = block_pcg.LAUNCHES, dc.LAUNCHES, int(total)
    st = res.stats
    general = st.lm_solves - st.rigid_solves
    rigid_dim = 3 * LARGE_POINTS + 8
    log(f"[large] n_valid={int(res.valid.sum())} rounds={res.rounds} weights={res.weights.tolist()} "
        f"rigid_accepted={res.rigid_accepted}")
    log(f"[large] initial_av_error_m={res.initial.av_error!r} final_av_error_m={res.final.av_error!r} "
        f"(JAX CPU {JAX_LARGE_INITIAL_AV_ERROR_M!r} -> {JAX_LARGE_FINAL_AV_ERROR_M!r})")
    log(f"[large] inner_solves={st.inner_solves} lm_iterations={st.lm_iterations} lm_solves={st.lm_solves} "
        f"(general {general}, rigid {st.rigid_solves}) pcg_launches={pcg} "
        f"pcg_by_dim={dict(block_pcg.LAUNCHES_BY_DIM)} pcg_iterations={iters} "
        f"mean_pcg_iterations={iters / max(pcg, 1):.2f} dense_launches={dense} "
        f"dense_by_dim={dict(sorted(dc.LAUNCHES_BY_DIM.items()))} wall_s={wall:.3f}")
    check(pcg > 0, "the large-N path did not launch the PCG kernel")
    check(dense > 0, "the large-N path did not launch the damped-Cholesky kernel")
    check(pcg == general, f"PCG launches {pcg} != general LM solves {general}")
    check(dense == dc.LAUNCHES_BY_DIM[rigid_dim] == st.rigid_solves,
          f"dense launches {dict(dc.LAUNCHES_BY_DIM)} != rigid LM solves {st.rigid_solves} at dim {rigid_dim}")
    check(int(res.valid.sum()) == JAX_LARGE_N_VALID, "n_valid differs from the JAX run")
    check(np.isfinite(res.final.av_error), "final error not finite")
    check(abs(res.initial.av_error - JAX_LARGE_INITIAL_AV_ERROR_M) < INITIAL_TOL_M,
          "initial av error differs from the JAX CPU value")
    check(abs(res.final.av_error - JAX_LARGE_FINAL_AV_ERROR_M) < FINAL_REL_TOL * JAX_LARGE_FINAL_AV_ERROR_M,
          "final av error outside the tolerance of the JAX CPU value")
    return pcg


def _on_cpu(nt):
    return type(nt)(*(v.cpu() if hasattr(v, "cpu") else v for v in nt))


def bign_phase():
    """solve_pair at 2600 points on cuda and on the CPU from the same first
    state, after TIED_ITERS and BIGN_ITERS LM iterations; LM iterations per
    second on the card."""
    import torch

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    data, state, hyper = _first_problem(BIGN_POINTS)
    spec = deformable.MODELS[sc.sweep_config().opt_model]
    cpu = (_on_cpu(data), _on_cpu(hyper), _on_cpu(state))
    run = lambda its: deformable.solve_pair("KB8", data, hyper, state, its, spec)
    total = block_pcg.iterations_total("cuda")
    block_pcg.LAUNCHES = 0
    total.zero_()
    solves = 0
    for its, rtol in ((TIED_ITERS, TIED_RTOL), (BIGN_ITERS, BIGN_COST_RTOL)):
        r_gpu = run(its)
        solves += r_gpu.n_solves
        t0 = time.perf_counter()
        r_cpu = deformable.solve_pair("KB8", *cpu, its, spec)
        cpu_s = time.perf_counter() - t0
        c_gpu, c_cpu = float(r_gpu.cost), float(r_cpu.cost)
        d = abs(c_gpu - c_cpu) / abs(c_cpu)
        log(f"[bigN] dim={6 * BIGN_POINTS + 8} iterations={its} cuda: accepted={r_gpu.n_accepted} "
            f"solves={r_gpu.n_solves} cost={c_gpu!r} initial={float(r_gpu.initial_cost)!r} | "
            f"cpu: accepted={r_cpu.n_accepted} solves={r_cpu.n_solves} cost={c_cpu!r} seconds={cpu_s:.2f} | "
            f"cost_rel_diff={d:.3e} (limit {rtol:.0e})")
        check(r_gpu.n_accepted == r_cpu.n_accepted, f"bigN accepted counts differ cuda vs cpu ({its} iterations)")
        check(d < rtol, f"bigN cost differs cuda vs cpu by {d:.3e} after {its} iterations")
        check(c_gpu < float(r_gpu.initial_cost), "bigN solve did not lower the cost")
    launches, iters = block_pcg.LAUNCHES, int(total)
    log(f"[bigN] pcg_launches={launches} pcg_iterations={iters} mean_pcg_iterations={iters / max(launches, 1):.2f}")
    check(launches == solves, f"bigN PCG launches {launches} != cuda LM solves {solves}")
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        run(BIGN_ITERS)
    torch.cuda.synchronize()
    it_s = BIGN_ITERS * reps / (time.perf_counter() - t0)
    log(f"[bigN] lm_iters_per_s={it_s:.2f} ({reps} solves of {BIGN_ITERS} LM iterations)")


def cross_large_phase():
    """The first large-N solve_pair with the kernel on cuda against the plain
    PCG on cuda and against the CPU: after each of 1..TIED_ITERS LM
    iterations the same accepted and damped-solve counts, and lambda and
    cost within TIED_RTOL of the card's plain run and of the CPU run. The
    CPU comparison holds while both devices' PCG solves took the same
    iteration counts: a solve whose early exit falls at r.r ~ tol2 can stop
    one iteration apart on the two devices (the card's f32 sums, the
    kernel's and the plain version's alike, against the CPU's), and the LM
    steps then differ by more than rounding (PERF.md, PR 6)."""
    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    data, state, hyper = _first_problem(LARGE_POINTS)
    spec = deformable.MODELS[sc.sweep_config().opt_model]
    cpu = (_on_cpu(data), _on_cpu(hyper), _on_cpu(state))
    dispatch = block_pcg.pcg_block_system
    counts = []

    def kernel(*args):
        x, k = block_pcg.pcg_block_system_cuda(*args)
        counts.append(int(k))
        return x

    def plain(*args):
        x, k = block_pcg.pcg_block_system_plain(*args)
        counts.append(k)
        return x

    def run(solver, args, its):
        counts.clear()
        block_pcg.pcg_block_system = solver
        try:
            r = deformable.solve_pair("KB8", *args, its, spec)
        finally:
            block_pcg.pcg_block_system = dispatch
        return r, list(counts)

    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))
    for its in range(1, TIED_ITERS + 1):
        (rg, cg), (rp, cp), (rc, cc) = (run(kernel, (data, hyper, state), its), run(plain, (data, hyper, state), its),
                                        run(plain, cpu, its))
        log(f"[cross-large] iterations={its} cuda: accepted={rg.n_accepted} solves={rg.n_solves} pcg={cg} "
            f"lam={float(rg.lam)!r} cost={float(rg.cost)!r} | cuda plain: pcg={cp} lam={float(rp.lam)!r} "
            f"cost={float(rp.cost)!r} | cpu: accepted={rc.n_accepted} solves={rc.n_solves} pcg={cc} "
            f"lam={float(rc.lam)!r} cost={float(rc.cost)!r} | vs cuda plain: lam_rel={rel(rg.lam, rp.lam):.3e} "
            f"cost_rel={rel(rg.cost, rp.cost):.3e} | vs cpu: lam_rel={rel(rg.lam, rc.lam):.3e} "
            f"cost_rel={rel(rg.cost, rc.cost):.3e}")
        for name, r in (("cuda plain", rp), ("cpu", rc)):
            check((rg.n_accepted, rg.n_solves) == (r.n_accepted, r.n_solves),
                  f"schedules differ kernel vs {name} after {its} iterations")
        check(rel(rg.lam, rp.lam) < TIED_RTOL and rel(rg.cost, rp.cost) < TIED_RTOL,
              f"lambda or cost differ kernel vs cuda plain after {its} iterations")
        if cg != cc:
            log(f"[cross-large] the PCG iteration counts part from the CPU's ({cg} vs {cc}): "
                f"cuda and cpu are no longer tied")
            break
        check(rel(rg.lam, rc.lam) < TIED_RTOL and rel(rg.cost, rc.cost) < TIED_RTOL,
              f"lambda or cost differ cuda vs cpu after {its} iterations")


def match_bound(n1, n2, n_rows, n_allowed):
    """Least time of one scan on this data: packed bits (32 bytes), position,
    r2 or validity and octave of every key read once and the three outputs
    written once, against a window test (8 operations) for each pair of an
    active row and a column plus 26 operations (8 XOR, 8 popc, 7 adds, the
    top-2 update) for each allowed pair, at the 67 T/s f32 peak rate (the
    card's INT32 rate is half that, so the bound is generous)."""
    nbytes = n1 * (32 + 8 + 4 + 4 + 1) + n2 * (32 + 8 + 4 + 1) + 12 * n1
    ops = 8.0 * n_rows * n2 + 26.0 * n_allowed
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _match_inputs(kp1, d1, o1, v1, kp2, d2, o2, v2, sf):
    """numpy arrays -> the scan's CUDA tensors (keypoints f32, bits uint8,
    octaves int32, masks bool, scale factors f32)."""
    import numpy as np
    import torch

    t = lambda x, dt: torch.as_tensor(np.array(x), device="cuda").to(dt)
    f32, u8, i32, b = torch.float32, torch.uint8, torch.int32, torch.bool
    return (t(kp1, f32), t(d1, u8), t(o1, i32), t(v1, b), t(kp2, f32), t(d2, u8), t(o2, i32), t(v2, b),
            t(sf, f32))


def _sweep_problem(n):
    """The JAX package's sweep inputs at n x n (bench.py:760-768)."""
    import numpy as np

    rng = np.random.default_rng(0)
    kp_ref = rng.uniform(0, 700, size=(n, 2)).astype(np.float32)
    kp_cur = rng.uniform(0, 700, size=(n, 2)).astype(np.float32)
    d_ref = rng.integers(0, 2, size=(n, 256)).astype(np.uint8)
    d_cur = rng.integers(0, 2, size=(n, 256)).astype(np.uint8)
    octave = np.zeros(n, np.int32)
    valid = np.ones(n, bool)
    sf = (np.full(8, 1.2) ** np.arange(8)).astype(np.float32)
    return kp_ref, d_ref, octave, valid, kp_cur, d_cur, octave, valid, sf


def _tie_problem():
    """Duplicated columns (first occurrence wins, second == best), two rows
    claiming one column at one distance, a key exactly on the radius-5
    circle, ten invalid rows and twenty invalid columns that would each be
    some row's exact match, and many rows with no allowed column."""
    import numpy as np

    rng = np.random.default_rng(11)
    n1, n2 = 300, 400
    kp1 = rng.uniform(0, 600, size=(n1, 2)).astype(np.float32)
    kp2 = rng.uniform(0, 600, size=(n2, 2)).astype(np.float32)
    d1 = rng.integers(0, 2, size=(n1, 256)).astype(np.uint8)
    d2 = rng.integers(0, 2, size=(n2, 256)).astype(np.uint8)
    for i in range(100):
        d2[2 * i] = d2[2 * i + 1] = d1[i]
        kp2[2 * i] = kp1[i] + 1.0
        kp2[2 * i + 1] = kp1[i] - 1.0
    d1[201] = d1[200]
    kp1[201] = kp1[200]
    d2[250] = d1[200]
    kp2[250] = kp1[200] + 2.0
    kp2[251] = kp1[202] + np.float32([3.0, 4.0])
    d2[251] = d1[202]
    v1 = np.ones(n1, bool)
    v1[-10:] = False
    v2 = np.ones(n2, bool)
    v2[-20:] = False
    for j, i in zip(range(360, 400), list(range(290, 300)) + list(range(220, 250))):
        d2[j] = d1[i]
        kp2[j] = kp1[i] + 0.5
    o1 = np.zeros(n1, np.int32)
    o2 = rng.integers(0, 3, size=n2).astype(np.int32)
    o2[:252] = 0
    o2[360:] = 0
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    return kp1, d1, o1, v1, kp2, d2, o2, v2, sf


def _lane_tie_problem():
    """Ties that the kernel's lanes must merge by column (lane l scans the
    columns j = l mod 32): rows whose best distance (0) is attained at
    columns (10, 11), (40, 72) in one lane, (8, 33) where the higher lane
    holds the lower column, (63, 64) and (255, 256) across lanes and tiles,
    (5, 261) in one lane across tiles, and (3, 34, 65) three ways; rows
    whose second best ties the best in another lane; rows far from every
    column and invalid rows; 611 columns, a multiple of neither 32 nor the
    256-column tile."""
    import numpy as np

    rng = np.random.default_rng(12)
    n1, n2 = 64, 611
    kp1 = rng.uniform(0, 600, size=(n1, 2)).astype(np.float32)
    kp2 = rng.uniform(0, 600, size=(n2, 2)).astype(np.float32)
    d1 = rng.integers(0, 2, size=(n1, 256)).astype(np.uint8)
    d2 = rng.integers(0, 2, size=(n2, 256)).astype(np.uint8)
    ties = [(10, 11), (40, 72), (8, 33), (63, 64), (255, 256), (5, 261), (3, 34, 65), (100, 395), (600, 610)]
    for i, cols in enumerate(ties):
        for k, j in enumerate(cols):
            d2[j] = d1[i]
            kp2[j] = kp1[i] + np.float32(0.5 * (k + 1))
    for i, (j0, j1, j2) in enumerate([(120, 150, 151), (200, 231, 230)], start=len(ties)):
        d2[j0] = d1[i]
        kp2[j0] = kp1[i] + 0.5
        for j in (j1, j2):
            d2[j] = d1[i]
            d2[j, :3] ^= 1
            kp2[j] = kp1[i] - 0.5
    kp1[40:50] = 5000.0
    v1 = np.ones(n1, bool)
    v1[50:54] = False
    o1 = np.zeros(n1, np.int32)
    o2 = np.zeros(n2, np.int32)
    v2 = np.ones(n2, bool)
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    return kp1, d1, o1, v1, kp2, d2, o2, v2, sf


def match_case(label, inputs, window, max_octave, th, ratio=0.9, timed=True):
    """Kernel 3 against its plain version on one input: the three outputs and
    the matches after the ratio test and ``_one_to_one`` bit-identical, also
    through ``search_for_initialization``'s dispatch; times and bound."""
    import torch

    from triangulation_in_deformable_scenes_torch.ops import match_scan as ms
    from triangulation_in_deformable_scenes_torch.ops import matching

    kp1, d1, o1, v1, kp2, d2, o2, v2, sf = inputs
    n1, n2 = kp1.shape[0], kp2.shape[0]
    r2, row_ok = ms.row_meta(kp1, o1, v1, sf, window, max_octave)
    args = (kp1, r2, o1, row_ok, d1, kp2, o2, v2, d2)
    got = ms.match_scan_cuda(*args)
    torch.cuda.synchronize()
    want = ms.match_scan_plain(*args)
    for name, g, w in zip(("best_d", "best", "second_d"), got, want):
        check(torch.equal(g, w), f"kernel 3 {name} differs from the plain version ({label})")
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))

    def finish(out):
        bd, b, sd = out
        return matching._one_to_one(b, bd, (bd <= th) & (bd < sd * ratio), n2)

    (mg, ng), (mw, nw) = finish(got), finish(want)
    m_path, n_path = matching.search_for_initialization(kp1, d1, o1, v1, kp2, d2, o2, v2, sf, th=th,
                                                        window_factor=window, ratio=ratio, max_octave=max_octave)
    check(torch.equal(mg, mw) and int(ng) == int(nw), f"kernel 3 matches differ from the plain version ({label})")
    check(torch.equal(m_path, mw) and int(n_path) == int(nw), f"search_for_initialization differs ({label})")
    allowed = ((matching._window_d2(kp1, kp2) <= r2[:, None]) & matching._octave_ok(o1, o2)
               & row_ok[:, None] & v2[None, :])
    n_allowed, n_rows = int(allowed.sum()), int(row_ok.sum())
    ties = int((got[0] == got[2]).logical_and(got[0] < ms.BIG).sum())
    empty = int((got[0] == ms.BIG).sum())
    row = dict(label=label, n1=n1, n2=n2, max_abs_err=err, n_matches=int(nw), n_allowed=n_allowed,
               library_ms=None)
    msg = (f"[match] {label} {n1}x{n2} bit-identical (best_d, best, second_d, matches) "
           f"n_matches={int(nw)} active_rows={n_rows} allowed_pairs={n_allowed} ties={ties} empty_rows={empty}")
    fn = lambda: ms.match_scan_cuda(*args)
    for _ in range(REPEATS):
        check(all(torch.equal(g, w) for g, w in zip(fn(), got)), f"a repeated scan is not bit-identical ({label})")
    if timed:
        launches = device_launches(fn, REPEATS)
        per_scan = sum(count for count, _ in launches.values()) / REPEATS
        check(per_scan == MATCH_LAUNCHES_PER_SCAN and all("match_scan" in name for name in launches),
              f"{REPEATS} scans launched {launches} ({label}), not {MATCH_LAUNCHES_PER_SCAN} match_scan kernels each")
        split = {re.search(r"match_scan\w*", name).group(0): count * per / REPEATS
                 for name, (count, per) in launches.items()}
        row["ms"] = sum(split.values())
        row["event_ms"] = time_ms(fn)
        row["host_us"] = host_us(fn)
        row["plain_ms"] = time_ms(lambda: ms.match_scan_plain(*args))
        row["bound_ms"], row["bound_by"] = match_bound(n1, n2, n_rows, n_allowed)
        msg += (f" grid={-(-n1 // 8)} blocks launches_per_scan={per_scan:g} repeats={REPEATS} bit-identical "
                f"ms={row['ms']:.4f} (device: "
                + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
                + f"; {row['event_ms']:.4f} by events around the wrapper, whose host time is "
                f"{row['host_us']:.1f} us) "
                f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.6f} ({row['bound_by']})")
    log(msg)
    return row


def match_phase():
    """Kernel 3 on the full-width frames' own keypoints, the sweep sizes and
    the tie / empty-row case; returns the 1000 x 1000 row."""
    from triangulation_in_deformable_scenes_torch.harness import step_scene as ss
    from triangulation_in_deformable_scenes_torch.pipeline import sequence as seq

    cfg = ss.scene_config(ss.FULL)
    pipe = seq.SequencePipeline(cfg, device="cuda")
    k1, k2 = (pipe.extract(seq.to_grayscale(f[0])) for f in ss.step_frames(ss.FULL))
    inputs = (k1.xy, k1.desc, k1.octave, k1.valid, k2.xy, k2.desc, k2.octave, k2.valid,
              pipe._t(pipe.scale_factors))
    path_row = match_case("frames", inputs, float(cfg.matching_init_radius), 0, float(cfg.matching_init_th))
    for n in MATCH_SWEEP:
        match_case("sweep", _match_inputs(*_sweep_problem(n)), MATCH_SWEEP_WINDOW, 0, 50.0)
    match_case("ties+empty", _match_inputs(*_tie_problem()), 5.0, 0, 60.0, timed=False)
    match_case("lane ties", _match_inputs(*_lane_tie_problem()), 5.0, 0, 60.0, timed=False)
    return path_row


def sequence_phase():
    """The sequence path at full width; returns the kernel-3 launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triangulation_in_deformable_scenes_torch.harness import step_scene as ss
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc
    from triangulation_in_deformable_scenes_torch.ops import match_scan as ms
    from triangulation_in_deformable_scenes_torch.ops import matching
    from triangulation_in_deformable_scenes_torch.pipeline import sequence as seq

    cfg = ss.scene_config(ss.FULL, 5, 8, 25)
    frames = ss.step_frames(ss.FULL)
    pipe = seq.SequencePipeline(cfg, device="cuda")
    spent = collections.defaultdict(list)
    n_valid = []

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key].append(time.perf_counter() - t)
            return out
        return wrapper

    extract = pipe.extract

    def extract_counted(gray):
        kps = extract(gray)
        n_valid.append(int(kps.valid.sum()))
        return kps

    pipe.extract = timed(extract_counted, "extract")
    pipe.initialize_pair = timed(pipe.initialize_pair, "initialize_pair")
    pipe._refine_and_report = timed(pipe._refine_and_report, "refine")
    search = matching.search_for_initialization
    matching.search_for_initialization = timed(search, "match")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ms.LAUNCHES = 0
            dc.LAUNCHES = 0
            dc.LAUNCHES_BY_DIM.clear()
            t0 = time.perf_counter()
            out = pipe.run(ss.StepSceneLoader(frames), journal_path=os.path.join(tmp, "Experiment.txt"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            scans, dense = ms.LAUNCHES, dc.LAUNCHES
    finally:
        matching.search_for_initialization = search
    check(out is not None, "the sequence path triangulated no pair")
    init, st = out["init"], out["stats"]
    attempts = len(spent["initialize_pair"])
    ms_of = lambda key: [round(1e3 * v, 3) for v in spent[key]]
    log(f"[sequence] n_valid={n_valid} n_matches={init.n_matches} n_triangulated={init.n_triangulated} "
        f"parallax_deg={init.parallax_deg!r} rounds={out['rounds']} weights={out['weights'].tolist()}")
    log(f"[sequence] initial_av_error_m={out['initial'].av_error!r} final_av_error_m={out['final'].av_error!r} "
        f"(JAX CPU {JAX_SEQ_INITIAL_AV_ERROR_M!r} -> {JAX_SEQ_FINAL_AV_ERROR_M!r})")
    log(f"[sequence] pair_attempts={attempts} kernel3_launches={scans} inner_solves={st.inner_solves} "
        f"lm_iterations={st.lm_iterations} lm_solves={st.lm_solves} (rigid {st.rigid_solves}) "
        f"kernel1_launches={dense} by_dim={dict(sorted(dc.LAUNCHES_BY_DIM.items()))}")
    log(f"[sequence] synchronized: phase_extract_ms={ms_of('extract')} phase_match_ms={ms_of('match')} "
        f"initialize_pair_ms={ms_of('initialize_pair')} refine_s={sum(spent['refine']):.3f} wall_s={wall:.3f}")
    check(scans >= 1, "the sequence path did not launch kernel 3")
    check(scans == attempts, f"kernel-3 launches {scans} != pair attempts {attempts}")
    check(dense > 0 and dense == st.lm_solves, f"kernel-1 launches {dense} != damped solves {st.lm_solves}")
    check(tuple(n_valid) == JAX_SEQ_N_VALID, f"valid keypoints {n_valid} != JAX {JAX_SEQ_N_VALID}")
    for name, got, want in (("matches", init.n_matches, JAX_SEQ_N_MATCHES),
                            ("map points", init.n_triangulated, JAX_SEQ_N_TRIANGULATED)):
        check(abs(got - want) <= SEQ_COUNT_REL_TOL * want, f"{name} {got} outside the tolerance of JAX {want}")
    check(abs(init.parallax_deg - JAX_SEQ_PARALLAX_DEG) <= SEQ_PARALLAX_TOL_DEG,
          f"parallax {init.parallax_deg} outside the tolerance of JAX {JAX_SEQ_PARALLAX_DEG}")
    for name, got, want in (("initial", out["initial"].av_error, JAX_SEQ_INITIAL_AV_ERROR_M),
                            ("final", out["final"].av_error, JAX_SEQ_FINAL_AV_ERROR_M)):
        check(np.isfinite(got) and abs(got - want) <= SEQ_ERROR_REL_TOL * want,
              f"{name} av error {got} outside the tolerance of JAX {want}")

    # Warm front end: one frame's extraction and the pair's match, CUDA
    # events (median of 10), then one extraction under torch.profiler.
    gray = seq.to_grayscale(frames[0][0])
    k1 = extract(gray)
    k2 = extract(seq.to_grayscale(frames[1][0]))
    sf = pipe._t(pipe.scale_factors)
    extract_ms = time_ms(lambda: extract(gray), reps=10)
    match_ms = time_ms(lambda: matching.search_for_initialization(
        k1.xy, k1.desc, k1.octave, k1.valid, k2.xy, k2.desc, k2.octave, k2.valid, sf,
        th=float(cfg.matching_init_th), window_factor=float(cfg.matching_init_radius)), reps=10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract(gray)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    busy = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()) / 1e6
    log(f"[sequence] warm: phase_extract_ms={extract_ms:.3f} phase_match_ms={match_ms:.3f} (events, median of 10); "
        f"one extraction profiled: window_s={window:.4f} device_s={busy:.4f} "
        f"device_idle_share={max(0.0, 1.0 - busy / window):.3f}")
    check(busy > 0, "the profiler saw no device time in the extraction")
    return scans


def features_phase():
    """The patch blur and the angle moments on the card against the CPU."""
    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch.ops import features as F

    rng = np.random.default_rng(3)
    P = rng.integers(0, 256, size=(300, 11, 11)).astype(np.float32)
    P = torch.as_tensor(np.repeat(np.repeat(P, 4, 1), 4, 2)[:, :43, :43].copy())
    P = P + torch.as_tensor(rng.uniform(0, 1, size=P.shape).astype(np.float32)) * (P > 128)
    blur_cpu, blur_gpu = F.blur_patches(P), F.blur_patches(P.cuda()).cpu()
    c = F.DESC_R - F.HALF_PATCH
    Pc = P[:, c:-c, c:-c].contiguous()
    ok = torch.ones(len(P), dtype=torch.bool)
    a_cpu, a_gpu = F.ic_angle_from_patches(Pc, ok), F.ic_angle_from_patches(Pc.cuda(), ok.cuda()).cpu()
    ulps = ((a_cpu.double() - a_gpu.double()).abs()
            / torch.as_tensor(np.spacing(np.maximum(a_cpu.abs().numpy(), a_gpu.abs().numpy())))).max().item()
    d_blur = int((blur_cpu != blur_gpu).sum())
    log(f"[features] blur outputs differing cuda vs cpu: {d_blur} of {blur_cpu.numel()}; "
        f"angles: max {ulps:.1f} ulp apart")
    check(d_blur == 0, "the patch blur on the card differs from the CPU's")
    check(ulps <= 2, "the angles on the card lie more than 2 ulp from the CPU's")


def sweep_phase():
    """The sweep harness on the card over two generated conditions."""
    import csv

    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch.harness import aggregate, sweep_config as sc
    from triangulation_in_deformable_scenes_torch.harness.sweep import SweepCondition, run_sweep
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    c = SWEEP_CONDITION
    conds = [SweepCondition(c["model"], c["triangulation"], c["depth_cm"], c["shape"], t, c["experiment"])
             for t in sorted(JAX_SWEEP)]
    with tempfile.TemporaryDirectory() as out:
        dc.LAUNCHES = 0
        dc.LAUNCHES_BY_DIM.clear()
        t0 = time.perf_counter()
        results = run_sweep(sc.sweep_config(), conds, out, seed=0, mesh_backend=sc.MESH_BACKEND, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dc.LAUNCHES
        solves = sum(r.stats.lm_solves for _, r in results)
        log(f"[sweep] {len(results)} conditions wall_s={wall:.3f} kernel1_launches={launches} "
            f"damped_solves={solves} by_dim={dict(sorted(dc.LAUNCHES_BY_DIM.items()))}")
        check(launches > 0 and launches == solves, f"kernel-1 launches {launches} != damped solves {solves}")
        for cond, res in results:
            want = JAX_SWEEP[cond.experiment_type]
            log(f"[sweep] type {cond.experiment_type}: n_valid={int(res.valid.sum())} rounds={res.rounds} "
                f"weights={res.weights.tolist()} initial_av_error_m={res.initial.av_error!r} "
                f"final_av_error_m={res.final.av_error!r} (JAX CPU {want['initial']!r} -> {want['final']!r}) "
                f"lm_solves={res.stats.lm_solves}")
            check(int(res.valid.sum()) == want["n_valid"], f"type {cond.experiment_type}: n_valid differs from JAX")
            check(abs(res.initial.av_error - want["initial"]) < INITIAL_TOL_M,
                  f"type {cond.experiment_type}: initial error differs from JAX")
            check(np.isfinite(res.final.av_error) and abs(res.final.av_error - want["final"]) < FINAL_REL_TOL * want["final"],
                  f"type {cond.experiment_type}: final error outside the tolerance of JAX")
        table = aggregate.write_condition_csv(os.path.join(out, "errors.csv"), out, [c["model"]], [c["triangulation"]],
                                              shapes=[c["shape"]], depth_cm=c["depth_cm"], experiment=c["experiment"])
        with open(table, newline="") as f:
            rows = list(csv.reader(f))
        tag = f"{c['model']}-{c['triangulation']}"
        check(rows[0] == ["Avg Movement", "Shape", "Gaussian Mov", "Rigid Mov", f"{tag} Initial (mm)",
                          f"{tag} Final (mm)"], f"unexpected CSV header {rows[0]}")
        check(len(rows) == 1 + len(conds), f"CSV rows {len(rows) - 1} != conditions {len(conds)}")
        for cond, row in zip(conds, rows[1:]):
            r = aggregate.journal_to_row(os.path.join(out, cond.result_dir, "Experiment.txt"))
            want_row = [aggregate._fmt(r["movement"]), c["shape"]] + row[2:4] + [
                aggregate._fmt(r["initial"]), aggregate._fmt(r["final"])]
            check(row == want_row, f"CSV row {row} != journal {want_row}")
        log(f"[sweep] write_condition_csv: {rows}")
    return launches


class _PoseFreeLoader:
    """The step scene's frames without their poses."""

    def __init__(self, frames):
        self._frames = frames

    def frames(self, start=0, end=None, step=1):
        for i, (rgb, depth, _pose) in enumerate(self._frames[start:end:step]):
            yield i, rgb, depth, None, float(i)


def posefree_phase():
    """The pose-free bootstrap on the full-width step scene."""
    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch.harness import step_scene as ss
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc
    from triangulation_in_deformable_scenes_torch.ops import match_scan as ms
    from triangulation_in_deformable_scenes_torch.pipeline import sequence as seq

    # One round of the refinement: the known-pose phase already runs the
    # full budget on this scene; what is new here is the bootstrap.
    pipe = seq.SequencePipeline(ss.scene_config(ss.FULL, *POSEFREE_BUDGET), device="cuda")
    attempts = []
    init_pair = pipe.initialize_pair

    def counted(*args, **kwargs):
        attempts.append(1)
        return init_pair(*args, **kwargs)

    pipe.initialize_pair = counted
    with tempfile.TemporaryDirectory() as tmp:
        ms.LAUNCHES = 0
        dc.LAUNCHES = 0
        dc.LAUNCHES_BY_DIM.clear()
        t0 = time.perf_counter()
        out = pipe.run(_PoseFreeLoader(ss.step_frames(ss.FULL)), journal_path=os.path.join(tmp, "Experiment.txt"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        scans, dense = ms.LAUNCHES, dc.LAUNCHES
    check(out is not None, "the pose-free sequence path triangulated no pair")
    init, st = out["init"], out["stats"]
    check(init.T2w_est is not None, "the pose-free branch did not run")
    R, t = (x.cpu().numpy().astype(np.float64) for x in init.T2w_est)
    t_true = -np.asarray(POSEFREE_BASELINE_M)
    rot_deg = float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))
    tdir_deg = float(np.degrees(np.arccos(np.clip(t @ t_true / (np.linalg.norm(t) * np.linalg.norm(t_true)), -1, 1))))
    scale = float(np.linalg.norm(t))
    log(f"[posefree] n_matches={init.n_matches} n_triangulated={init.n_triangulated} "
        f"parallax_deg={init.parallax_deg!r} R21_from_identity_deg={rot_deg:.6f} t21_direction_error_deg={tdir_deg:.5f} "
        f"t21_norm_m={scale:.7f} (truth {np.linalg.norm(t_true):.5f})")
    log(f"[posefree] initial_av_error_m={out['initial'].av_error!r} final_av_error_m={out['final'].av_error!r} "
        f"pair_attempts={len(attempts)} kernel3_launches={scans} kernel1_launches={dense} "
        f"lm_solves={st.lm_solves} wall_s={wall:.3f}")
    check(scans >= 1 and scans == len(attempts), f"kernel-3 launches {scans} != pair attempts {len(attempts)}")
    check(dense > 0 and dense == st.lm_solves, f"kernel-1 launches {dense} != damped solves {st.lm_solves}")
    check(rot_deg <= POSEFREE_ROT_TOL_DEG, f"R21 {rot_deg:.3f} deg from the identity")
    check(tdir_deg <= POSEFREE_TDIR_TOL_DEG, f"t21 direction {tdir_deg:.2f} deg from the baseline's")
    check(abs(scale - np.linalg.norm(t_true)) <= POSEFREE_SCALE_RTOL * np.linalg.norm(t_true), f"|t21| {scale:.5f} m")
    for name, got, want, band in zip(("R21", "t21 direction", "|t21|"), (rot_deg, tdir_deg, scale),
                                     (POSEFREE_CARD_ROT_DEG, POSEFREE_CARD_TDIR_DEG, POSEFREE_CARD_NORM_M),
                                     POSEFREE_CARD_BAND):
        check(abs(got - want) <= band, f"{name} {got} outside {band} of the card's recorded draw {want}")
    for name, got, want in (("matches", init.n_matches, JAX_SEQ_N_MATCHES),
                            ("map points", init.n_triangulated, JAX_SEQ_N_TRIANGULATED)):
        check(abs(got - want) <= SEQ_COUNT_REL_TOL * want, f"{name} {got} outside the tolerance of JAX {want}")
    check(np.isfinite(out["final"].av_error), "the pose-free final error is not finite")
    return scans


def selection_phase():
    """open3DArap and eigen on the card, reduced fixture."""
    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch.models import outer
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    for name, over, want, tol in (
        ("open3DArap", {"opt_selection": "open3DArap"}, JAX_OPEN3D_FINAL_AV_ERROR_M, OPEN3D_TOL_M),
        ("eigen", {"opt_weights_selection": "eigen"}, JAX_EIGEN_FINAL_AV_ERROR_M,
         FINAL_REL_TOL * JAX_EIGEN_FINAL_AV_ERROR_M),
    ):
        dc.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run_pipeline("cuda", **REDUCED, overrides=over)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dc.LAUNCHES
        log(f"[selection] {name}: rounds={res.rounds} weights={res.weights.tolist()} "
            f"initial_av_error_m={res.initial.av_error!r} final_av_error_m={res.final.av_error!r} "
            f"(JAX CPU {JAX_REDUCED_INITIAL_AV_ERROR_M!r} -> {want!r}) lm_solves={res.stats.lm_solves} "
            f"kernel1_launches={launches} wall_s={wall:.3f}")
        check(abs(res.initial.av_error - JAX_REDUCED_INITIAL_AV_ERROR_M) < INITIAL_TOL_M, f"{name}: initial error")
        check(np.isfinite(res.final.av_error) and abs(res.final.av_error - want) < tol,
              f"{name}: final error outside the tolerance of JAX")
        check(launches == res.stats.lm_solves, f"{name}: kernel-1 launches {launches} != damped solves")
        if name == "eigen":
            check(launches > 0, "the eigen selection launched no damped solve")

    # The wide-step eigen run: its LM steps follow the objective, so the card
    # takes JAX's.
    real = outer._numdiff_lm
    outer._numdiff_lm = functools.partial(real, eps_rel=EIGEN_WIDE_EPS_REL)
    try:
        dc.LAUNCHES = 0
        res = run_pipeline("cuda", REDUCED["num_points"], **EIGEN_WIDE_BUDGET, overrides=EIGEN_WIDE_OVERRIDES)
        launches = dc.LAUNCHES
    finally:
        outer._numdiff_lm = real
    want = JAX_EIGEN_WIDE_FINAL_AV_ERROR_M
    log(f"[selection] eigen, wide step: weights={res.weights.tolist()} final_av_error_m={res.final.av_error!r} "
        f"(JAX CPU {list(JAX_EIGEN_WIDE_WEIGHTS)} -> {want!r}) lm_solves={res.stats.lm_solves} "
        f"kernel1_launches={launches}")
    check(np.allclose(res.weights, JAX_EIGEN_WIDE_WEIGHTS, rtol=1e-9, atol=0), "eigen, wide step: weights not JAX's")
    check(abs(res.final.av_error - want) < EIGEN_WIDE_REL_TOL * want, "eigen, wide step: final error outside JAX's")
    check(launches > 0 and launches == res.stats.lm_solves, f"eigen, wide step: kernel-1 launches {launches}")


def viz_phase():
    """The visualisers and the map layer on the card's simulation."""
    import numpy as np

    from triangulation_in_deformable_scenes_torch.viz import draw

    with tempfile.TemporaryDirectory() as work:
        res = run_pipeline("cuda", REDUCED["num_points"], **VIZ_BUDGET, overrides={"show_scene": True, "show_solution": True},
                           workdir=work)
        vdir = os.path.join(work, "viz")
        names = sorted(os.listdir(vdir))
        pngs = [f for f in names if f.endswith(".png")]
        plys = [f for f in names if f.endswith(".ply")]
        check(len(pngs) == 1 and len(plys) == 1, f"viz files {names}")
        im = draw.read_png(os.path.join(vdir, pngs[0]))
        n_valid = int(res.valid.sum())
        with open(os.path.join(vdir, plys[0])) as f:
            ply = f.read()
    m = res.world_map
    kfs = sorted(m.keyframes)
    obs = [len(m.kf_obs[k]) for k in kfs]
    log(f"[viz] {pngs[0]} {im.shape} drawn_pixels={int((im != 255).any(-1).sum())} {plys[0]} "
        f"n_valid={n_valid} map_points={len(m.map_points)} observations={obs}")
    check(im.shape == (800, 800, 3) and (im != 255).any(), "the snapshot PNG is empty or misshapen")
    check(f"element vertex {2 * n_valid + 2}" in ply, "the PLY does not hold 2 x n_valid points and two cameras")
    check(len(kfs) == 2 and len(m.map_points) == 2 * n_valid and obs == [n_valid, n_valid],
          "world_map does not hold n_valid map-point pairs")


def _batch_systems(B, dim):
    """B systems of make_system's kind (one seed each) on the card:
    H [B, dim, dim], g [B, dim], lam [B]."""
    import numpy as np
    import torch

    Hs, gs, lams = zip(*(make_system(dim, seed=1000 * dim + k) for k in range(B)))
    t = lambda a: torch.as_tensor(np.stack(a), device="cuda")
    return t(Hs), t(gs), torch.tensor(lams, dtype=torch.float32, device="cuda")


def batched_case(B, dim):
    """Kernel 1's batched entry on B systems of one dim: every member bit for
    bit the single launch's, one launch per call, REPEATS calls
    bit-identical, a non-PD member non-finite alone; times of the batched
    call, of B single launches, of the plain version and of the library's
    batched factorization and solve."""
    import torch

    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    H, g, lam = _batch_systems(B, dim)
    batched = lambda: dc.damped_solve_batched_cuda(H, g, lam)
    singles = lambda: torch.stack([dc.damped_solve_cuda(H[k], g[k], lam[k]) for k in range(B)])
    x = batched()
    xs = singles()
    torch.cuda.synchronize()
    check(torch.equal(x, xs), f"batched kernel differs from the single launches (B={B}, dim={dim})")
    xp = dc.solve_damped_cholesky_batched_plain(H, g, lam)
    err = float((x - xp).abs().max())
    rel = max(float((x[k] - xp[k]).abs().max() / xp[k].abs().max()) for k in range(B))
    check(bool(torch.isfinite(x).all()) and rel < KERNEL_REL_TOL,
          f"batched kernel vs plain relative error {rel:.3e} (B={B}, dim={dim})")
    for _ in range(REPEATS):
        check(torch.equal(batched(), x), f"a repeated batched call is not bit-identical (B={B}, dim={dim})")
    launches = device_launches(batched, REPEATS)
    seen = sum(count for count, _ in launches.values())
    check(seen == REPEATS and all("damped_solve_kernel" in name for name in launches),
          f"{REPEATS} batched calls launched {launches} (B={B}, dim={dim}), not one damped_solve_kernel each")
    device_ms = sum(ms for _, ms in launches.values())

    bad = B // 2
    Hbad = H.clone()
    Hbad[bad, dim // 3, dim // 3] = -float(H[bad, dim // 3, dim // 3]) - 1.0
    lam0 = torch.zeros(B, device="cuda")
    xbad = dc.damped_solve_batched_cuda(Hbad, g, lam0)
    torch.cuda.synchronize()
    finite = torch.isfinite(xbad).all(dim=1).tolist()
    check(not finite[bad] and all(f for k, f in enumerate(finite) if k != bad),
          f"non-PD member {bad}: finite rows {finite} (B={B}, dim={dim})")
    for k in range(B):
        if k != bad:
            check(torch.equal(xbad[k], dc.damped_solve_cuda(H[k], g[k], 0.0)),
                  f"member {k} beside a non-PD one differs from its single launch (B={B}, dim={dim})")

    A = H + lam[:, None, None] * torch.eye(dim, device="cuda")

    def library():
        Lf, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(-g[..., None], Lf)

    ms = time_ms(batched)
    singles_ms = time_ms(singles)
    plain_ms = time_ms(lambda: dc.solve_damped_cholesky_batched_plain(H, g, lam))
    library_ms = time_ms(library)
    one_ms, bound_by = bound(dim)
    grid = dc._load().tids_damped_solve_batched_grid(B, dim)
    log(f"[batched] B={B} dim={dim} grid={grid} blocks members==single bit-identical max_abs_err={err:.3e} "
        f"rel_err={rel:.3e} non_pd=member {bad} alone repeats={REPEATS} bit-identical "
        f"launches_per_call={seen / REPEATS:g} ms={ms:.4f} device_ms={device_ms:.4f} "
        f"singles_ms={singles_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={B * one_ms:.5f} ({bound_by})")
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms, singles_ms=singles_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=B * one_ms, bound_by=bound_by)


def batched_kernel_phase():
    """Kernel 1's batched entry at B in BATCHES and dims BATCH_DIMS; returns
    the rows by (B, dim)."""
    return {(B, dim): batched_case(B, dim) for dim in BATCH_DIMS for B in BATCHES}


def _reset_kernel_counts():
    from triangulation_in_deformable_scenes_torch.ops import block_pcg
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    dc.LAUNCHES = dc.LAUNCHES_BATCHED = block_pcg.LAUNCHES = 0
    dc.LAUNCHES_BY_DIM.clear()
    dc.LAUNCHES_BATCHED_BY_SHAPE.clear()
    block_pcg.LAUNCHES_BY_DIM.clear()


def _hold_to_jax(label, costs, accepted, want_costs, want_accepted, rel_tol):
    """Per pair: n_accepted equal to JAX's and the cost within ``rel_tol`` of
    JAX's."""
    for i, (c, a, wc, wa) in enumerate(zip(costs, accepted, want_costs, want_accepted)):
        check(a == wa, f"{label} pair {i}: n_accepted {a} != JAX's {wa}")
        check(abs(c - wc) <= rel_tol * abs(wc), f"{label} pair {i}: cost {c!r} outside {rel_tol} of JAX's {wc!r}")


def _spread(costs, want):
    """Largest relative difference over the pairs."""
    return f"{max(abs(a / b - 1) for a, b in zip(costs, want)):.3e}"


def _costs(res):
    return [float(c) for c in res.cost.cpu()], [int(a) for a in res.n_accepted.cpu()]


def serving_phase():
    """The serving fixtures on the card (phase 18); returns the dense run's
    batched kernel-1 launches and its result."""
    import torch

    from triangulation_in_deformable_scenes_torch.harness import serving
    from triangulation_in_deformable_scenes_torch.models import block_system, deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg, lm
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    B, iters = serving.BATCH, serving.ITERATIONS
    fx = serving.serving_batch(serving.POINTS, rotations=JAX_SERVING_DENSE_FREE_RI)
    dim = 6 * serving.POINTS + 8
    check(len(fx.datas) == B and fx.data.nbr.shape[-1] == serving.DEGREE_BUCKET, f"serving fixture kept {fx.kept}")
    check(deformable.use_dense_backend(serving.POINTS, serving.DEGREE_BUCKET, B), "the dense fixture is not dense")

    # While the runs are tied (and as the warm-up of the timed runs).
    ct, at = _costs(deformable.solve_pairs("KB8", fx.data, fx.hyper, fx.state, SERVING_TIED_ITERS))
    log(f"[serving] free vertices pinned to JAX's rotations per pair {[len(f) for f in fx.free]}; solve_pairs "
        f"after {SERVING_TIED_ITERS} iteration: cost vs JAX CPU {_spread(ct, JAX_SERVING_DENSE_TIED_COST)} "
        f"(limit {TIED_RTOL})")
    _hold_to_jax("tied solve_pairs", ct, at, JAX_SERVING_DENSE_TIED_COST, JAX_SERVING_DENSE_TIED_N_ACCEPTED,
                 TIED_RTOL)

    _reset_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rb = deformable.solve_pairs("KB8", fx.data, fx.hyper, fx.state, iters)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    batched, by_shape, singles = dc.LAUNCHES_BATCHED, dict(dc.LAUNCHES_BATCHED_BY_SHAPE), dc.LAUNCHES
    log(f"[serving] solve_pairs {B} x {serving.POINTS} points (dim {dim}) x {iters} iterations: wall_s={wall_b:.3f} "
        f"global_steps={rb.n_solves} batched_kernel1_launches={batched} by_shape={by_shape} single_launches={singles} "
        f"peak_memory_bytes={peak}")
    check(batched == rb.n_solves and by_shape == {(B, dim): batched} and singles == 0,
          f"batched launches {by_shape} (single {singles}) != one per global step ({rb.n_solves})")

    _reset_kernel_counts()
    t0 = time.perf_counter()
    rp = deformable.solve_pairs_pipelined("KB8", fx.datas, fx.hyper, fx.states, iters)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    solves = sum(r.n_solves for r in rp)
    log(f"[serving] solve_pairs_pipelined: wall_s={wall_p:.3f} damped_solves={solves} "
        f"kernel1_launches={dc.LAUNCHES} by_dim={dict(dc.LAUNCHES_BY_DIM)} batched_launches={dc.LAUNCHES_BATCHED}")
    check(dc.LAUNCHES == solves and dict(dc.LAUNCHES_BY_DIM) == {dim: solves} and dc.LAUNCHES_BATCHED == 0,
          f"pipelined kernel-1 launches {dc.LAUNCHES} != damped solves {solves}")

    cb, ab = _costs(rb)
    cp = [float(r.cost) for r in rp]
    ap = [r.n_accepted for r in rp]
    bit_equal = sum(torch.equal(rb.cost[i], r.cost) and all(torch.equal(x[i], y) for x, y in zip(rb.state, r.state))
                    for i, r in enumerate(rp))
    spread = max(abs(a / b - 1) for a, b in zip(cb, cp))
    log(f"[serving] per pair: n_accepted batched {ab} pipelined {ap}; cost max relative difference "
        f"batched/pipelined {spread:.3e} ({bit_equal} of {B} pairs bit-equal in cost and state), "
        f"vs JAX CPU {_spread(cb, JAX_SERVING_DENSE_COST)} (batched) "
        f"{_spread(cp, JAX_SERVING_DENSE_PIPELINED_COST)} (pipelined; limit {FINAL_REL_TOL})")
    check(ab == ap and spread <= 1e-5, "solve_pairs and solve_pairs_pipelined disagree")
    _hold_to_jax("solve_pairs", cb, ab, JAX_SERVING_DENSE_COST, JAX_SERVING_DENSE_N_ACCEPTED, FINAL_REL_TOL)
    _hold_to_jax("solve_pairs_pipelined", cp, ap, JAX_SERVING_DENSE_PIPELINED_COST,
                 JAX_SERVING_DENSE_PIPELINED_N_ACCEPTED, FINAL_REL_TOL)
    check(all(c < 0.1 * float(i) for c, i in zip(cb, rb.initial_cost.cpu())), "the serving costs did not descend")
    log("[serving] " + json.dumps({
        "serving_batch": B,
        "serving_pairs_per_sec": B / wall_p,
        "serving_lm_iters_per_sec": B * iters / wall_p,
        "serving_batched_lm_iters_per_sec": B * iters / wall_b,
    }))

    # One global step's split: every assembly, the batched solve and every
    # cost timed between synchronizes over one more solve_pairs run.
    targets = [(deformable, "build_system", "assembly"), (lm, "solve_damped_cholesky_batched", "solve"),
               (deformable, "robust_cost", "cost")]
    with synchronized_split(targets) as spent:
        t0 = time.perf_counter()
        rs = deformable.solve_pairs("KB8", fx.data, fx.hyper, fx.state, iters)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    steps = rs.n_solves
    log(f"[serving] one global step of {B} pairs, synchronized (mean of {steps}): "
        f"step_ms={1e3 * wall_s / steps:.3f} assembly_ms={1e3 * spent['assembly'] / steps:.3f} "
        f"solve_ms={1e3 * spent['solve'] / steps:.3f} cost_ms={1e3 * spent['cost'] / steps:.3f} "
        f"host_loop_ms={1e3 * (wall_s - sum(spent.values())) / steps:.3f}")

    # The block branch: 16 pairs of 680 points, over the dense budget.
    fb = serving.serving_batch(serving.BLOCK_POINTS, rotations=JAX_SERVING_BLOCK_FREE_RI)
    nb, bdim = serving.BLOCK_POINTS, 6 * serving.BLOCK_POINTS + 8
    check(len(fb.datas) == B and not deformable.use_dense_backend(nb, serving.DEGREE_BUCKET, B),
          "the block fixture does not run on the block backend")
    ct, at = _costs(deformable.solve_pairs("KB8", fb.data, fb.hyper, fb.state, SERVING_TIED_ITERS))
    log(f"[serving] block branch: free vertices pinned per pair {[len(f) for f in fb.free]}; after "
        f"{SERVING_TIED_ITERS} iteration: cost vs JAX CPU {_spread(ct, JAX_SERVING_BLOCK_TIED_COST)} "
        f"(limit {TIED_RTOL})")
    _hold_to_jax("tied block-branch solve_pairs", ct, at, JAX_SERVING_BLOCK_TIED_COST,
                 JAX_SERVING_BLOCK_TIED_N_ACCEPTED, TIED_RTOL)
    _reset_kernel_counts()
    t0 = time.perf_counter()
    rk = deformable.solve_pairs("KB8", fb.data, fb.hyper, fb.state, serving.BLOCK_ITERATIONS)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    pcg = block_pcg.LAUNCHES
    log(f"[serving] block branch {B} x {nb} points (dim {bdim}) x {serving.BLOCK_ITERATIONS} iterations: "
        f"wall_s={wall_k:.3f} global_steps={rk.n_solves} kernel2_launches={pcg} "
        f"by_dim={dict(block_pcg.LAUNCHES_BY_DIM)} kernel1_launches={dc.LAUNCHES + dc.LAUNCHES_BATCHED}")
    check(pcg == B * rk.n_solves and dict(block_pcg.LAUNCHES_BY_DIM) == {bdim: pcg}
          and dc.LAUNCHES + dc.LAUNCHES_BATCHED == 0,
          f"kernel-2 launches {pcg} != the pairs' damped solves {B} x {rk.n_solves}")
    ck, ak = _costs(rk)
    # Each pair alone on the block backend (solve_pair's branch above the
    # dense limits; one pair of 680 points alone is under the budget, so
    # solve_pair itself would run it dense).
    spec = deformable.ModelSpec()
    singles = [lm.lm_optimize_general(
        block_system.make_block_step("KB8", d, fb.hyper, spec, deformable.CG_ITERS, deformable.CG_RTOL),
        lambda st, d=d: deformable.robust_cost("KB8", d, fb.hyper, st, spec), deformable.apply_delta_spec(spec),
        s, serving.BLOCK_ITERATIONS) for d, s in zip(fb.datas, fb.states)]
    flat_vs_single = max(abs(a / float(r.cost) - 1) for a, r in zip(ck, singles))
    log(f"[serving] block branch per pair: n_accepted {ak} (JAX {JAX_SERVING_BLOCK_N_ACCEPTED}); cost max relative "
        f"difference vs each pair alone on the block backend {flat_vs_single:.3e}, vs JAX CPU "
        f"{_spread(ck, JAX_SERVING_BLOCK_COST)} (limit {TIED_RTOL})")
    check(ak == [r.n_accepted for r in singles] and flat_vs_single <= 1e-5,
          "block-branch solve_pairs differs from each pair's block solve")
    _hold_to_jax("block-branch solve_pairs", ck, ak, JAX_SERVING_BLOCK_COST, JAX_SERVING_BLOCK_N_ACCEPTED,
                 TIED_RTOL)
    return batched, rb


def ba_phase():
    """Bundle adjustment on the card (phase 19)."""
    import numpy as np
    import torch

    from triangulation_in_deformable_scenes_torch import convert
    from triangulation_in_deformable_scenes_torch.harness import ba_scene
    from triangulation_in_deformable_scenes_torch.models import bundle_adjustment as ba
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    data, state, pts = ba_scene.ba_problem(**BA_SCENE)
    K, M = BA_SCENE["n_kf"], BA_SCENE["n_pts"]
    dim = 6 * K + 3 * M
    kf, mp = data["obs_kf"], data["obs_mp"]
    z = (np.einsum("eij,ej->ei", state["R"][kf], state["points"][mp]) + state["t"][kf])[:, 2]
    check(bool((z > 0).all()), "an observation lies behind its camera")
    td, ts = convert.ba_data_from_numpy(data), convert.ba_state_from_numpy(state)
    _reset_kernel_counts()
    t0 = time.perf_counter()
    r1 = ba.bundle_adjustment("KB8", td, ts, n_iterations=BA_ITERATIONS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_dim = dc.LAUNCHES, dict(dc.LAUNCHES_BY_DIM)
    r2 = ba.bundle_adjustment("KB8", td, ts, n_iterations=BA_ITERATIONS)
    same = torch.equal(r1.cost, r2.cost) and all(torch.equal(a, b) for a, b in zip(r1.state, r2.state))
    err = float(np.linalg.norm(r1.state.points.cpu().numpy().astype(np.float64) - pts, axis=-1).mean())
    cost = float(r1.cost)
    log(f"[ba] {K} keyframes x {M} points (dim {dim}, {K * M} observations), {BA_ITERATIONS} iterations: "
        f"wall_s={wall:.3f} cost {float(r1.initial_cost)!r} -> {cost!r} (JAX CPU {JAX_BA_FINAL_COST!r}) "
        f"mean_point_error_m={err!r} (JAX CPU {JAX_BA_MEAN_POINT_ERROR_M!r}) n_accepted={r1.n_accepted} "
        f"(JAX {JAX_BA_N_ACCEPTED}) damped_solves={r1.n_solves} kernel1_launches={launches} by_dim={by_dim} "
        f"second run bit-identical={same}")
    check(launches == r1.n_solves and by_dim == {dim: launches}, f"kernel-1 launches {by_dim} != damped solves")
    check(same, "two BA runs on the card differ")
    check(torch.equal(r1.state.R[:2], ts.R[:2]) and torch.equal(r1.state.t[:2], ts.t[:2]), "a fixed pose moved")
    check(abs(cost - JAX_BA_FINAL_COST) <= BA_COST_RTOL * JAX_BA_FINAL_COST, "BA cost outside the limit of JAX's")
    check(abs(err - JAX_BA_MEAN_POINT_ERROR_M) <= BA_POINT_RTOL * JAX_BA_MEAN_POINT_ERROR_M,
          "BA mean point error outside the limit of JAX's")

    p, uv, R0, t0_, _, _ = ba_scene.pose_only_problem(n_pts=M, n_outliers=POSE_ONLY_OUTLIERS)
    _reset_kernel_counts()
    t0 = time.perf_counter()
    Rp, tp, mask = ba.pose_only_optimization("KB8", ba_scene.CAM, p, uv, np.ones(M), R0, t0_)
    wall = time.perf_counter() - t0
    outliers = np.nonzero(~mask)[0].tolist()
    dR = float(np.abs(Rp - np.asarray(JAX_POSE_ONLY_R)).max())
    dt = float(np.abs(tp - np.asarray(JAX_POSE_ONLY_T)).max())
    log(f"[ba] pose-only {M} points, {POSE_ONLY_OUTLIERS} outliers: wall_s={wall:.3f} outliers found "
        f"{len(outliers)} (JAX's: {outliers == JAX_POSE_ONLY_OUTLIERS}) pose from JAX R {dR:.3e} t {dt:.3e} "
        f"kernel1_launches={dc.LAUNCHES} by_dim={dict(dc.LAUNCHES_BY_DIM)}")
    check(outliers == JAX_POSE_ONLY_OUTLIERS, "pose-only inlier mask differs from JAX's")
    check(dR <= 1e-5 and dt <= 1e-5, "pose-only pose outside 1e-5 of JAX's")
    check(dc.LAUNCHES > 0 and set(dc.LAUNCHES_BY_DIM) == {6}, "pose-only did not run kernel 1 at dim 6")

    pts_s, poses, obs = ba_scene.make_scene(M, K, noise_px=BA_SCENE["noise_px"])
    wm, _ = ba_scene.make_map(pts_s, poses, obs)
    wm.keyframes[1].kp[0] += 50.0
    t0 = time.perf_counter()
    got = ba.local_bundle_adjustment(wm, 1, "KB8", ba_scene.CAM, n_iterations=LOCAL_BA_ITERATIONS)
    log(f"[ba] local BA on keyframe 1: (n_edges, n_removed)={got} (JAX CPU {JAX_LOCAL_BA}) "
        f"wall_s={time.perf_counter() - t0:.3f}")
    check(tuple(got) == tuple(JAX_LOCAL_BA), "local BA's (n_edges, n_removed) differ from JAX's")


def _parallel_rank(p):
    """One rank of phase 20 (run by ``parallel/launch.run_ranks``): each
    (kind, iterations) task of ``p["tasks"]`` with the kernel and all-reduce
    counts reset just before and read just after."""
    import torch
    import torch.distributed as tdist

    from triangulation_in_deformable_scenes_torch.harness import scaling
    from triangulation_in_deformable_scenes_torch.models import block_system, deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc
    from triangulation_in_deformable_scenes_torch.parallel import dist, halo
    from triangulation_in_deformable_scenes_torch.parallel.multihost_worker import _tiny_problem

    mesh = dist.make_mesh("cuda")
    on_card = lambda tup: type(tup)(*(x.to(mesh.device) for x in tup))
    data, state, hyper = (on_card(x) for x in p["pair"])
    out = {}
    for kind, it in p["tasks"]:
        _reset_kernel_counts()
        dist.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "pcg":
            # One sharded damped solve of the pair's first system (``it``:
            # "halo" in the plan's Morton layout, or "distributed").
            plan = halo.plan_halo(state.p1.cpu().numpy(), data.nbr.cpu().numpy(), data.nbr_mask.cpu().numpy(),
                                  mesh.size)
            d, s = (halo.permute_data(data, plan), halo.permute_state(state, plan)) if it == "halo" else (data, state)
            sd, ss = dist.shard_pair(mesh, d, s)
            sp = dist.ShardedPair(mesh, "KB8", sd, hyper, deformable.ModelSpec())
            sys_, _ = sp.system(ss)
            lam = torch.tensor(p["lam"], device=mesh.device)
            if it == "halo":
                x_p, x_g = halo.pcg_halo_local(sp, sys_, lam, halo.place_plan(mesh, plan), deformable.CG_ITERS,
                                               deformable.CG_RTOL)
            else:
                x_p, x_g = dist.pcg_sharded(sp, sys_, lam, dist.full_exchange_matvec(sp, sys_, sd.nbr, lam),
                                            deformable.CG_ITERS, deformable.CG_RTOL)
            x = block_system._join(dist.gather_rows(mesh, dist.POINTS_AXIS, x_p, "gather_x"), x_g)
            out[(kind, it)] = dict(x=x.cpu(), iterations=dist.COUNTS["cg_iterations"])
            continue
        if kind == "halo":
            r = halo.solve_pair_halo(mesh, "KB8", data, hyper, state, it, cg_iters=scaling.CG_ITERS)
        elif kind == "serving":
            bd, bs, bh = (on_card(x) for x in p["serving"])
            r = dist.solve_pairs_sharded(dist.make_serving_mesh("cuda"), "KB8", bd, bh, bs, it)
        else:
            d, h, s = (data, hyper, state) if kind == "distributed" else _tiny_problem(TINY_SIDE, mesh.device)
            d, s, _ = halo.pad_pair(d, s, mesh.size)
            sd, ss = dist.shard_pair(mesh, d, s)
            r = dist.solve_pair_distributed("KB8", sd, h, ss, it, cg_iters=scaling.CG_ITERS, mesh=mesh)
        torch.cuda.synchronize()
        row = dict(wall_s=time.perf_counter() - t0, n_solves=r.n_solves, counts=dict(dist.COUNTS),
                   k2=block_pcg.LAUNCHES, k2_by_dim=dict(block_pcg.LAUNCHES_BY_DIM), k1=dc.LAUNCHES,
                   k1_batched=dc.LAUNCHES_BATCHED, k1_batched_by_shape=dict(dc.LAUNCHES_BATCHED_BY_SHAPE))
        if kind == "serving":
            row.update(state=type(r.state)(*(x.cpu() for x in r.state)), cost=r.cost.cpu(),
                       n_accepted=r.n_accepted.cpu())
        else:
            row.update(cost=float(r.cost), n_accepted=int(r.n_accepted))
        out[(kind, it)] = row
    if tdist.is_initialized() and tdist.get_backend() == "nccl":
        # A world of one issues no collective in the solves; this one NCCL
        # all-reduce, of the last task's cost on the card, must give it back.
        before = torch.as_tensor(out[p["tasks"][-1]]["cost"], dtype=torch.float32).reshape(-1).to(mesh.device)
        after = before.clone()
        tdist.all_reduce(after)
        torch.cuda.synchronize()
        out["nccl"] = dict(world=tdist.get_world_size(), floats=after.numel(), same=torch.equal(before, after))
    return out


def _hold_sharded(label, ranks, task, want, n_boundary=None, n=None):
    """Phase 20's checks of one landmark-sharded run over several ranks:
    every rank's cost bit for bit the same, within the limit of JAX's
    ``want``, three all-reduces a CG iteration with the fused buffer's size,
    no kernel launched (the sharded PCG is plain torch and collectives)."""
    it = task[1]
    rows = [r[task] for r in ranks]
    costs = [r["cost"] for r in rows]
    c = rows[0]["counts"]
    k, solves = c.get("cg_iterations", 0), c.get("pcg_solves", 0)
    per_matvec = c.get("pcg_matvec_floats", 0) / max(c.get("pcg_matvec", 0), 1)
    tol = PARALLEL_TIED_RTOL if it == 1 else FINAL_REL_TOL
    log(f"[parallel] {label} x {it} iterations on {len(ranks)} ranks: wall_s="
        f"{max(r['wall_s'] for r in rows):.3f} cost {costs[0]!r} (JAX CPU {want!r}, {abs(costs[0] / want - 1):.3e}, "
        f"limit {tol}) n_accepted={rows[0]['n_accepted']} damped_solves={rows[0]['n_solves']} cg_iterations={k} "
        f"all_reduces_per_cg_iteration={(c.get('pcg_matvec', 0) + c.get('pcg_dot', 0) + c.get('pcg_rz_rr', 0) - solves) / max(k, 1):g} "
        f"floats_per_matvec_exchange={per_matvec:g} bytes_per_matvec_exchange={4 * per_matvec:g} "
        f"all_reduces={ {t: v for t, v in c.items() if not t.endswith('_floats') and t not in ('cg_iterations', 'pcg_solves')} }")
    check(all(x == costs[0] for x in costs), f"{label}: ranks' costs differ {costs}")
    check(abs(costs[0] - want) <= tol * abs(want), f"{label} x {it}: cost outside {tol} of JAX's")
    check(k > 0 and c["pcg_matvec"] == k and c["pcg_dot"] == k and c["pcg_rz_rr"] == k + solves,
          f"{label}: not three all-reduces a CG iteration ({c})")
    size = 6 * n_boundary + 8 if n_boundary is not None else 6 * n + 8
    check(per_matvec == size, f"{label}: the matvec exchange holds {per_matvec:g} floats, not {size}")
    check(all(r["k2"] == 0 and r["k1"] + r["k1_batched"] == 0 for r in rows),
          f"{label}: a kernel launched in the sharded PCG")


def parallel_phase(serving_ref=None):
    """parallel/ on the card (phase 20); returns kernel 2's row at the
    scaled pair's size, its launches in the world-1 solve. ``serving_ref``
    is phase 18's unsharded ``solve_pairs`` on the same fixture (run here
    when not given)."""
    import concurrent.futures

    import torch

    from triangulation_in_deformable_scenes_torch.harness import scaling, serving
    from triangulation_in_deformable_scenes_torch.models import block_system, deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg, lm
    from triangulation_in_deformable_scenes_torch.parallel import halo, launch

    t0 = time.perf_counter()
    data, state, hyper, fv = scaling.scaling_pair(rotations=JAX_SCALING_FREE_RI)
    n, K = data.nbr.shape
    dim = 6 * n + 8
    log(f"[parallel] the scaled pair: {n} points (dim {dim}, K={K}), {len(fv)} free vertices pinned to JAX's "
        f"rotations; built in {time.perf_counter() - t0:.2f} s")
    for S in PARALLEL_WORLDS:
        plan = halo.plan_halo(state.p1.cpu().numpy(), data.nbr.cpu().numpy(), data.nbr_mask.cpu().numpy(), S)
        log(f"[parallel] plan over {S} ranks: n_boundary={plan.n_boundary} (JAX {JAX_SCALING_N_BOUNDARY[S]}), "
            f"off-shard edges per rank {plan.off_w.sum(axis=1).astype(int).tolist()}")
        check(plan.n_boundary == JAX_SCALING_N_BOUNDARY[S], f"n_boundary over {S} ranks differs from JAX's")

    # Kernel 2 on the world-1 path's first system; the plain PCG on it (and
    # on its Morton-permuted copy) is what the sharded solves are held to.
    spec = deformable.ModelSpec()
    sys0 = block_system.build_block_system("KB8", data, hyper, state, spec)
    lam = lm.TAU * torch.max(block_system.diag_of(sys0))
    row = pcg_check(f"scaled pair, {n} points", sys0, data.nbr, -block_system.flat_gradient(sys0), lam)
    plain = lambda sys_, nbr: block_pcg.pcg_block_system_plain(
        sys_, nbr, -block_system.flat_gradient(sys_), lam, deformable.CG_ITERS, deformable.CG_RTOL)
    pcg_refs = {"distributed": plain(sys0, data.nbr)}
    del sys0
    for S in PARALLEL_WORLDS:
        plan = halo.plan_halo(state.p1.cpu().numpy(), data.nbr.cpu().numpy(), data.nbr_mask.cpu().numpy(), S)
        dp = halo.permute_data(data, plan)
        pcg_refs[S] = plain(block_system.build_block_system("KB8", dp, hyper, halo.permute_state(state, plan), spec),
                            dp.nbr)

    fx = serving.serving_batch(serving.POINTS, rotations=JAX_SERVING_DENSE_FREE_RI)
    ref = serving_ref
    if ref is None:
        ref = deformable.solve_pairs("KB8", fx.data, fx.hyper, fx.state, serving.ITERATIONS)
    cpu = lambda tup: type(tup)(*(x.cpu() for x in tup))
    payload = dict(pair=(cpu(data), cpu(state), cpu(hyper)), serving=(cpu(fx.data), cpu(fx.state), cpu(fx.hyper)),
                   lam=float(lam))
    landmark = [(kind, it) for kind in ("distributed", "halo") for it in PARALLEL_ITERS]
    serving_task = ("serving", serving.ITERATIONS)

    def ranks(world, tasks, backend=None):
        t0 = time.perf_counter()
        out = launch.run_ranks(world, "chip_smoke:_parallel_rank", dict(payload, tasks=tasks), device="cuda",
                               backend=backend, timeout=PARALLEL_TIMEOUT_S, cwd=REPO)
        return out, time.perf_counter() - t0

    def worker(mode):
        t0 = time.perf_counter()
        outs = launch.spawn(2, ["-m", f"{PKG}.parallel.multihost_worker", mode, "--device", "cuda", "--backend",
                                "gloo"], timeout=PARALLEL_TIMEOUT_S, cwd=REPO)
        return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs], time.perf_counter() - t0

    def hold_serving(label, ranks):
        for rank, r in enumerate(ranks):
            g = r[serving_task]
            same = (torch.equal(g["cost"], ref.cost.cpu()) and torch.equal(g["n_accepted"], ref.n_accepted.cpu())
                    and all(torch.equal(a, b.cpu()) for a, b in zip(g["state"], ref.state)))
            per = serving.BATCH // len(ranks)
            log(f"[parallel] {label} rank {rank}: pairs bit-identical to the unsharded solve_pairs: {same}; "
                f"global_steps={g['n_solves']} batched_kernel1_launches={g['k1_batched']} "
                f"by_shape={g['k1_batched_by_shape']} single={g['k1']} wall_s={g['wall_s']:.3f}")
            check(same, f"{label} rank {rank}: the pair-sharded batch differs from the unsharded one")
            check(g["k1_batched"] == g["n_solves"] and g["k1_batched_by_shape"] == {(per, 6 * serving.POINTS + 8):
                                                                                  g["n_solves"]} and g["k1"] == 0,
                  f"{label} rank {rank}: batched kernel-1 launches != global steps")

    def hold_nccl(label, rank):
        g = rank.get("nccl")
        log(f"[parallel] {label}: one NCCL all_reduce of the last cost on the card: {g}")
        check(g is not None and g["world"] == 1 and g["same"], f"{label}: the NCCL all_reduce changed the cost")

    # World 1 on NCCL, alone on the card: kernel 2, no collective issued in
    # the solves.
    (w1,), wall = ranks(1, landmark)
    log(f"[parallel] world 1 on NCCL: {wall:.1f} s of command time")
    for kind, it in landmark:
        g = w1[(kind, it)]
        want = JAX_SCALING_COST[it]
        tol = PARALLEL_TIED_RTOL if it == 1 else FINAL_REL_TOL
        log(f"[parallel] world 1 {kind} x {it}: wall_s={g['wall_s']:.3f} cost {g['cost']!r} (JAX CPU {want!r}, "
            f"{abs(g['cost'] / want - 1):.3e}) n_accepted={g['n_accepted']} damped_solves={g['n_solves']} "
            f"kernel2_launches={g['k2']} by_dim={g['k2_by_dim']} all_reduces={g['counts']}")
        check(g["k2"] == g["n_solves"] and g["k2_by_dim"] == {dim: g["n_solves"]},
              f"world 1 {kind}: kernel-2 launches != damped solves")
        check(not g["counts"], f"world 1 {kind}: a collective was issued")
        check(abs(g["cost"] - want) <= tol * want, f"world 1 {kind} x {it}: cost outside {tol} of JAX's")
    hold_nccl("world 1", w1)
    for it in PARALLEL_ITERS:
        a, b = w1[("halo", it)]["cost"], w1[("distributed", it)]["cost"]
        log(f"[parallel] world 1 halo vs distributed x {it}: {abs(a / b - 1):.3e} (limit {HALO_ONE_SHARD_RTOL})")
        check(abs(a - b) <= HALO_ONE_SHARD_RTOL * b, f"one-rank halo x {it} differs from the baseline")

    # Then, all at once on the one card: serving at world 1 (NCCL), worlds
    # 2 and 4 over gloo (a logic check, not scaling) and the multihost
    # worker's two modes at 2 ranks over gloo.
    world2 = [("pcg", "halo"), ("pcg", "distributed")] + [("halo", it) for it in PARALLEL_ITERS] + [
        (kind, it) for kind in ("tiny", "distributed") for it in PARALLEL_ITERS] + [serving_task]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        jobs = {"serving 1": pool.submit(ranks, 1, [serving_task]),
                2: pool.submit(ranks, 2, world2, "gloo"),
                4: pool.submit(ranks, 4, [("pcg", "halo")] + [("halo", it) for it in PARALLEL_ITERS], "gloo"),
                "baseline": pool.submit(worker, "baseline"), "halo": pool.submit(worker, "halo")}
        done = {k: f.result() for k, f in jobs.items()}
    log(f"[parallel] serving at world 1, worlds 2 and 4, and the worker's two modes at once: "
        f"{time.perf_counter() - t0:.1f} s of command time; each: "
        + ", ".join(f"{k}: {v[1]:.1f} s" for k, v in done.items()))
    hold_serving("world 1 serving", done["serving 1"][0])
    hold_nccl("world 1 serving", done["serving 1"][0][0])
    for S in PARALLEL_WORLDS:
        rs = done[S][0]
        for kind in ("halo", "distributed") if S == 2 else ("halo",):
            x_ref, k_ref = pcg_refs[S if kind == "halo" else kind]
            x_ref = x_ref.cpu()
            for rank, r in enumerate(rs):
                g = r[("pcg", kind)]
                rel = float((g["x"] - x_ref).abs().max() / x_ref.abs().max())
                log(f"[parallel] world {S} {kind} PCG on the first system, rank {rank}: iterations={g['iterations']} "
                    f"(plain, one device: {k_ref}) x vs plain {rel:.3e} (limit {PCG_SHARDED_RTOL})")
                check(g["iterations"] == k_ref and rel <= PCG_SHARDED_RTOL,
                      f"world {S} {kind} PCG differs from the plain one-device PCG")
                check(torch.equal(g["x"], rs[0][("pcg", kind)]["x"]), f"world {S} {kind} PCG: ranks' x differ")
        for it in PARALLEL_ITERS:
            _hold_sharded(f"world {S} halo", rs, ("halo", it), JAX_SCALING_HALO_COST[(S, it)],
                          n_boundary=JAX_SCALING_N_BOUNDARY[S])
        if S == 2:
            for it in PARALLEL_ITERS:
                _hold_sharded("world 2 baseline, 5 x 5 problem", rs, ("tiny", it), JAX_TINY_COST[it],
                              n=TINY_SIDE * TINY_SIDE + 1)
                _hold_sharded("world 2 baseline", rs, ("distributed", it), JAX_SCALING_COST[it], n=n)
            hold_serving("world 2 serving over gloo", rs)
    for mode in ("baseline", "halo"):
        res = done[mode][0]
        log(f"[parallel] multihost_worker {mode}, 2 ranks: {[(r['process_id'], r['final_cost']) for r in res]}")
        check(all(r["descended"] for r in res) and res[0]["final_cost"] == res[1]["final_cost"],
              f"multihost_worker {mode}: ranks differ or did not descend")
    return dict(row, launches=w1[("distributed", PARALLEL_ITERS[-1])]["k2"])


def setup():
    """Card line and build; returns the card line."""
    import torch

    from triangulation_in_deformable_scenes_torch.device import resolve_device
    from triangulation_in_deformable_scenes_torch.ops import _nvcc

    resolve_device("cuda")
    card = card_line()
    log(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _nvcc.build()
    log(f"[build] {os.path.relpath(lib, REPO)} from {len(_nvcc.sources())} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in _nvcc.BUILD_LOG.splitlines():
        if line.startswith("==") or "spill" in line or ("ptxas info" in line and ("Used" in line or "Compiling" in line)):
            log(f"[build] {line.strip()}")
    return card


def main():
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke.py must run from a checkout that holds {PKG}/", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA card only", file=sys.stderr)
        return 3
    sys.path.insert(0, REPO)

    t_start = time.perf_counter()
    card = setup()
    r = kernel_phase()
    refinement_phase()
    pcg_rows = {n: pcg_case(n) for n in (LARGE_POINTS, BIGN_POINTS)}
    pcg_stride_case()
    serving_pcg_case()
    launches = main_path_phase()
    split_phase(240)
    cross_device_phase()
    pcg_launches = large_main_phase()
    split_phase(LARGE_POINTS)
    bign_phase()
    cross_large_phase()
    m = match_phase()
    scan_launches = sequence_phase()
    features_phase()
    for phase in (sweep_phase, posefree_phase, selection_phase, viz_phase):
        t0 = time.perf_counter()
        phase()
        log(f"[{phase.__name__}] passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rb = batched_kernel_phase()[(16, 776)]
    log(f"[batched_kernel_phase] passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batched_launches, serving_result = serving_phase()
    log(f"[serving_phase] passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ba_phase()
    log(f"[ba_phase] passed in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pp = parallel_phase(serving_result)
    log(f"[parallel_phase] passed in {time.perf_counter() - t0:.1f} s")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    p = pcg_rows[LARGE_POINTS]
    print(json.dumps({"kernels": [{
        "name": "damped_cholesky",
        "route": "cuda",
        "source": f"{PKG}/csrc/damped_cholesky.cu",
        "replaces": "triangulation_in_deformable_scenes_tpu/ops/pallas_cholesky.py:248",
        "launches": launches,
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    }, {
        "name": "block_pcg",
        "route": "cuda",
        "source": f"{PKG}/csrc/block_pcg.cu",
        "replaces": "triangulation_in_deformable_scenes_tpu/ops/pallas_pcg.py:221",
        "launches": pcg_launches,
        "max_abs_err": p["max_abs_err"],
        "ms": p["ms"],
        "plain_ms": p["plain_ms"],
        "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"],
        "library_ms": p["library_ms"],
    }, {
        "name": "match_scan",
        "route": "cuda",
        "source": f"{PKG}/csrc/match_scan.cu",
        "replaces": "triangulation_in_deformable_scenes_tpu/ops/pallas_kernels.py:156",
        "launches": scan_launches,
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
    }, {
        "name": "damped_cholesky_batched",
        "route": "cuda",
        "source": f"{PKG}/csrc/damped_cholesky.cu",
        "replaces": "triangulation_in_deformable_scenes_tpu/ops/pallas_cholesky.py:248",
        "launches": batched_launches,
        "max_abs_err": rb["max_abs_err"],
        "ms": rb["ms"],
        "plain_ms": rb["plain_ms"],
        "bound_ms": rb["bound_ms"],
        "bound_by": rb["bound_by"],
        "library_ms": rb["library_ms"],
    }, {
        "name": "block_pcg_16384",
        "route": "cuda",
        "source": f"{PKG}/csrc/block_pcg.cu",
        "replaces": "triangulation_in_deformable_scenes_tpu/ops/pallas_pcg.py:221",
        "launches": pp["launches"],
        "max_abs_err": pp["max_abs_err"],
        "ms": pp["ms"],
        "plain_ms": pp["plain_ms"],
        "bound_ms": pp["bound_ms"],
        "bound_by": pp["bound_by"],
        "library_ms": pp["library_ms"],
        "host_us": pp["host_us"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
