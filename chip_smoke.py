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
   general solve), 2591 (the 861-point rigid solve) and 4096 (the dense
   ceiling), diagonal scales 1e-3..1e5, relative error < 1e-5 of
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
   (the strided kernel, fewer warps than points).
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

Then it prints the ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``. It exits non-zero without a card, and
when run from a directory that does not hold the package.

Reference values (``JAX_*``): the JAX package on the CPU, same fixture, seed
and budget, produced by

    JAX_PLATFORMS=cpu python tests/test_torch_problems.py --points 240 --rounds 5 --evals 8 --iters 25
    JAX_PLATFORMS=cpu python tests/test_torch_problems.py --points 861 --rounds 5 --evals 8 --iters 25
    JAX_PLATFORMS=cpu python tests/test_torch_sequence.py --rounds 5 --evals 8 --iters 25

(the last with ``--port`` gives the port's own CPU values, from which the
``SEQ_*`` tolerances are set).
"""

from __future__ import annotations

import collections
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


def device_launches(fn, reps=20):
    """CUDA kernel launches over ``reps`` calls of ``fn`` and their mean
    device time (ms) per launch, by kernel name, from ``torch.profiler``.
    The calls are recorded in the active step of a schedule whose warm-up
    step runs them once before, with PROFILE_MARGIN_S of idle host time at
    both ends of each step: kernels near the edges of the window went
    unrecorded (read: 13 of 20 solves at dim 1448 without the warm-up step,
    19 of 20 at 4096 without the margins)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
    return {ev.key: (ev.count, ev.self_device_time_total / ev.count / 1e3)
            for ev in prof.key_averages() if ev.self_device_time_total > 0}


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
    for dim in (377, 728, 746, 1448, 2591, 4096):
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


def run_pipeline(device, num_points, rounds, evals, iters, seed=0):
    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.pipeline.simulation import SimulationPipeline

    cfg = sc.sweep_config(n_optimizations=rounds, nlopt_evals=evals, n_opt_iterations=iters)
    with tempfile.TemporaryDirectory() as tmp:
        of, mf = sc.write_fixture(os.path.join(tmp, "fixture"), num_points=num_points, seed=seed)
        pipe = SimulationPipeline(cfg, seed=seed, mesh_backend=sc.MESH_BACKEND, device=device)
        return pipe.run(of, mf, journal_path=os.path.join(tmp, "Experiment.txt"))


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

    spent = {"assembly": 0.0, "solve": 0.0, "cost": 0.0}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return wrapper

    targets = [(deformable, "build_system", "assembly"), (block_system, "build_block_system", "assembly"),
               (rigid, "build_system_rigid", "assembly"), (lm, "solve_damped_cholesky", "solve"),
               (block_pcg, "pcg_block_system", "solve"), (deformable, "robust_cost", "cost"),
               (rigid, "robust_cost_rigid", "cost")]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for mod, name, key in targets:
        setattr(mod, name, timed(getattr(mod, name), key))
    try:
        t0 = time.perf_counter()
        res = run_pipeline("cuda", num_points, 1, 8, 25)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
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
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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
    launches = main_path_phase()
    split_phase(240)
    cross_device_phase()
    pcg_launches = large_main_phase()
    split_phase(LARGE_POINTS)
    bign_phase()
    cross_large_phase()
    m = match_phase()
    scan_launches = sequence_phase()
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
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
