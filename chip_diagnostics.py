#!/usr/bin/env python3
"""Diagnostics of the torch port on one NVIDIA card, beside chip_smoke.py.
They print readings and check only what is stated; PERF.md cites them.

    python3 chip_diagnostics.py [mutants] [match_mutants] [chol_mutants] [chol_profile] [pcg_profile] [rounding] [profiler]
    python3 chip_diagnostics.py chol_parity=OTHER_damped_cholesky.cu
    python3 chip_diagnostics.py pcg_variants extract_parent=build/parent
    python3 chip_diagnostics.py halo_mutants

(no argument runs the first seven)

- ``mutants``: copies the package and chip_smoke.py into a temporary
  directory, breaks ``csrc/block_pcg.cu`` there in one place (no neighbour
  products, no point-to-global coupling in the point rows or in the global
  rows, no Hg, no preconditioner, or the neighbours' last p read from the
  half of the ping-pong pair that the iteration writes), and prints for
  each the tight-solve residuals of chip_smoke.py's two right-hand sides
  and the check of ``chip_smoke.pcg_case(861)`` that fails. Exits non-zero
  if a broken kernel passes that phase.
- ``match_mutants``: the same for kernel 3, ``csrc/match_scan.cu``: the
  last occurrence winning a tie, a displaced best not becoming the second,
  no window test, no octave gate, no column validity, no row flag, the
  lanes' results merged by lane order instead of column; each must fail
  ``chip_smoke.match_phase()``.
- ``chol_mutants``: the same for kernel 1, ``csrc/damped_cholesky.cu``: no
  trailing update of the diagonal tiles, the refinement residual without
  its lam x0 term, and the grid.sync() between the factorization and the
  first solve removed; each must fail ``chip_smoke.kernel_phase()`` or
  ``refinement_phase()`` (an accuracy or a repeated-call check).
- ``halo_mutants``: the same for ``parallel/`` (not in the default set):
  the CG stop test on the rank's own r.r, Hg from the rank's partial sum
  (before the all-reduce), the boundary rows read before the exchange, the
  off-shard tail dropped; each must fail ``chip_smoke.parallel_phase()``.
- ``chol_profile``: kernel 1 at dims 377, 1448, 2591 and 4096 under
  ``torch.profiler`` (launches and device time per solve by CUDA kernel
  name, CUDA events beside them) and its per-phase times from the
  globaltimer stamps of ``tids_damped_solve_timed``.
- ``pcg_profile``: kernel 2 on the large-N path's first systems at 861 and
  2600 points: the grid, CUDA events and device time of the path's solve
  and of the tight one, both split into phases by the SM clock of block 0
  (``chip_smoke.pcg_phases``), and the split of one iteration.
- ``pcg_variants``: kernel 2 as kept against the designs of PCG_VARIANTS
  (the 3-blocks-an-SM kernel where 2 suffice, approximate quotients in the
  inverses), each built in a temporary copy: iterations, device time, µs
  per iteration, prologue.
- ``extract_parent=PATH``: the warm full-width extraction in another
  checkout (the parent commit unpacked with ``git archive``) and in this
  tree, alternated, one process each.
- ``chol_parity=PATH``: kernel 1 bit for bit against another version of
  its source, built into a library of its own, on chip_smoke.py's systems.
- ``rounding``: ``solve_pair`` from the first state at 2600 and 861 points
  for 1..10 LM iterations, four ways: the kernel on the card, the plain PCG
  on the card, f32 on the CPU, f64 on the CPU; accepted and damped-solve
  counts, lambda and cost of each.
- ``profiler``: the 240- and 861-point main paths of chip_smoke.py twice
  each, then once more each after one ``torch.profiler`` session in the same
  process; the wall times are in their ``[main]``/``[large]`` lines.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

import chip_smoke as c

PKG = c.PKG
MUTANTS = {
    "no_neighbours": ("acc[(4 * q + u) / 6] += e[u] * v[(4 * q + u) % 6];",
                      "acc[(4 * q + u) / 6] += 0.0f * v[(4 * q + u) % 6];"),
    "no_C_in_point_rows": ("y += Cm[la * 8 + g] * s_pg[g];", "y += 0.0f * s_pg[g];"),
    "no_C_in_global_rows": ("ct += Cm[c * 8 + lane] * pv[c];", "ct += 0.0f * pv[c];"),
    "no_Hg": ("const float apg = (pick(reinterpret_cast<const float(&)[8]>(t), lg) + hgp) + lam * pg;",
              "const float apg = (pick(reinterpret_cast<const float(&)[8]>(t), lg) + 0.0f * hgp) + lam * pg;"),
    "no_preconditioner": ("    inv_spd_rows(arow, lam, lr, lane & 24, mrow);\n",
                          "    for (int c = 0; c < 8; ++c) mrow[c] = c == lr ? 1.0f : 0.0f;\n"),
    # The neighbours' last p read from the half that this iteration writes.
    "stale_ping_pong": ("if (RES) nb = load_nbr(a.z, pnext, j_res);", "if (RES) nb = load_nbr(a.z, pprev, j_res);"),
}
MATCH_MUTANTS = {
    "last_occurrence": ("if (D < best) {", "if (D <= best) {"),
    "second_not_displaced": ("        second = best;\n        best = D;", "        best = D;"),
    "no_window": ("d2 <= rr && ", ""),
    "no_octave_gate": ("oc >= o - 1 && oc <= o + 1", "true"),
    "no_column_validity": ("s_valid[t] && ", ""),
    "no_row_flag": ("    if (!ok) continue;", ""),
    # The lanes' results merged by lane order instead of column index.
    "merge_by_lane": ("(ob == best && oi < bi)", "(ob == best && (lane ^ off) < lane)"),
}
MATCH_PROBE = "import chip_smoke as c\nc.setup()\nc.match_phase()\n"
# Kernel 2 designs measured against the kept one (``variants``).
PCG_VARIANTS = {
    # The 3-blocks-an-SM resident kernel (80 registers, spills) also where 2
    # blocks an SM hold a warp per point.
    "three_blocks_per_sm": ("  if (K <= 32 && want <= cap_few) return", "  if (false && want <= cap_few) return"),
    # Approximate quotients and square roots in the row-parallel inverses.
    "approximate_inverses": (
        ("    L[j] = l < j ? 0.0f : (l == j ? Ljj : acc / Ljj);",
         "    L[j] = l < j ? 0.0f : (l == j ? Ljj : __fdividef(acc, Ljj));"),
        ("    const float Ljj = __shfl_sync(FULL, sqrtf(fmaxf(acc, TINY)), base + j);",
         "    const float Ljj = __shfl_sync(FULL, fmaxf(acc, TINY) * rsqrtf(fmaxf(acc, TINY)), base + j);"),
        ("  const float inv_ll = 1.0f / pick(L, l);", "  const float inv_ll = __fdividef(1.0f, pick(L, l));"),
    ),
}
VARIANT_PROBE = r"""
import chip_smoke as c
from triangulation_in_deformable_scenes_torch.models import deformable
from triangulation_in_deformable_scenes_torch.ops import block_pcg
c.setup()
for n in (c.LARGE_POINTS, c.BIGN_POINTS):
    sys_, nbr, b, lam = c._block_problem(n)
    its, rtol = deformable.CG_ITERS, deformable.CG_RTOL
    solve = lambda: block_pcg.pcg_block_system_cuda(sys_, nbr, b, lam, its, rtol)
    tight = lambda: block_pcg.pcg_block_system_cuda(sys_, nbr, b, lam, c.PCG_TIGHT_CAP, c.PCG_TIGHT_RTOL)
    k, kp, kt = int(solve()[1]), block_pcg.pcg_block_system_plain(sys_, nbr, b, lam, its, rtol)[1], int(tight()[1])
    ms, tms = c.device_ms(solve, "pcg_kernel"), c.device_ms(tight, "pcg_kernel", reps=5)
    split, _ = c.pcg_phases(sys_, nbr, b, lam, its, rtol)
    lib = block_pcg._load()
    print(f"[variant] N={n} grid={lib.tids_pcg_grid(n, nbr.shape[1])} resident={lib.tids_pcg_resident(n, nbr.shape[1])} "
          f"iterations={k} (plain {kp}) ms={ms:.4f} tight_iterations={kt} us_per_iteration={1e3 * (tms - ms) / (kt - k):.2f} "
          f"prologue_us={1e3 * split['prologue']:.2f}", flush=True)
"""
# The warm extraction of one full-width frame, timed in the tree it runs from.
EXTRACT_PROBE = r"""
import statistics, sys, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
from triangulation_in_deformable_scenes_torch.harness import step_scene as ss
from triangulation_in_deformable_scenes_torch.pipeline import sequence as seq
pipe = seq.SequencePipeline(ss.scene_config(ss.FULL), device="cuda")
gray = seq.to_grayscale(ss.step_frames(ss.FULL)[0][0])
for _ in range(3):
    pipe.extract(gray)
times = []
for _ in range(20):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    pipe.extract(gray)
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    pipe.extract(gray)
    torch.cuda.synchronize()
launches = sum(ev.count for ev in prof.key_averages() if ev.self_device_time_total > 0)
print(f"[extract] median_ms={statistics.median(times):.3f} min_ms={min(times):.3f} launches={launches}", flush=True)
"""
# Kernel 1: one mutant may break several lines (pairs of old, new).
CHOL_MUTANTS = {
    "no_diagonal_tile_update": (
        ("= o[u][v] - acc[u][v];", "= i == j ? o[u][v] : o[u][v] - acc[u][v];"),
        ("Q1[(ty + 16 * u) * TS + tx + 16 * v] -= acc[u][v];", "Q1[(ty + 16 * u) * TS + tx + 16 * v] -= 0.0f * acc[u][v];"),
    ),
    "no_lam_x0_in_residual": ("(acc + lam * __ldcg(a.x0 + row))", "(acc)"),
    "no_sync_before_substitution": (
        "    grid.sync();\n  }\n  if (stamp) a.stamps[2] = now_ns();",
        "    if (c + 1 < NB) grid.sync();\n  }\n  if (stamp) a.stamps[2] = now_ns();",
    ),
}
CHOL_PROBE = "import chip_smoke as c\nc.setup()\nc.kernel_phase()\nc.refinement_phase()\n"
# The sharded PCG of parallel/ broken in one place each; every one must fail
# chip_smoke.parallel_phase() (phase 20), as it fails tests/test_torch_parallel.py
# on the CPU. Keyed by the package file they edit.
HALO_MUTANTS = {
    "parallel/dist.py": {
        # The stop test on the rank's own r.r: ranks leave the CG loop apart
        # and the next all-reduces pair up wrongly (or wait until the
        # process group's timeout).
        "rank_local_stop_test": ("return red[0] + torch.dot(r_g, z_g), red[1] + torch.dot(r_g, r_g)",
                                 "return red[0] + torch.dot(r_g, z_g), torch.sum(r_p * r_p) + torch.dot(r_g, r_g)"),
        # Hg (and so its inverse, the global block's preconditioner) from
        # the rank's own partial sum, before the all-reduce.
        "hg_before_all_reduce": ("Hg, g_g = red[:64].reshape(8, 8).clone(), red[64:72].clone()",
                                 "Hg, g_g = sys.Hg.clone(), red[64:72].clone()"),
    },
    "parallel/halo.py": {
        # The boundary rows read from the rank's own buffer, before the
        # exchange: other ranks' rows read zero.
        "boundary_before_exchange": ("halo = buf[: nb * 6].reshape(nb, 6)", "halo = halo_in"),
        "no_off_shard_tail": ("y_p = y_p + tail.sum(dim=1)", "y_p = y_p + 0.0 * tail.sum(dim=1)"),
    },
}
HALO_PROBE = "import chip_smoke as c\nc.setup()\nc.parallel_phase()\n"
PROBE = r"""
import torch, chip_smoke as c
from triangulation_in_deformable_scenes_torch.models import block_system as bs
from triangulation_in_deformable_scenes_torch.ops import block_pcg
c.setup()
sys_, nbr, b, lam = c._block_problem(861)
n = nbr.shape[0]
s64 = bs.BlockSystem(*(a.double() for a in sys_))
xs = torch.zeros(6 * n + 8, dtype=torch.float64, device=b.device)
xs[6 * n:] = torch.rsqrt(torch.diagonal(s64.Hg) + lam.double())
for label, rhs in (("-g", b), ("global", bs.block_matvec(s64, nbr, xs, lam.double()).float())):
    x, k = block_pcg.pcg_block_system_cuda(sys_, nbr, rhs, lam, c.PCG_TIGHT_CAP, c.PCG_TIGHT_RTOL)
    res = bs.block_matvec(s64, nbr, x.double(), lam.double()) - rhs.double()
    print("[mutant] rhs", label, "iterations", int(k), "residual", float(res.norm() / rhs.double().norm()), flush=True)
c.pcg_case(861)
"""


def mutants(source="block_pcg.cu", table=MUTANTS, probe=PROBE) -> bool:
    """Each broken kernel must fail its probe (kernel 2: chip_smoke.pcg_case(861));
    ``table`` maps a name to one (old, new) pair or to a tuple of them, in
    ``source`` (a file of ``csrc/``, or a path inside the package). Also
    runs the kernel variants of ``variants``, whose probe prints readings."""
    all_failed = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, spec in table.items():
            dst = os.path.join(tmp, name)
            shutil.copytree(os.path.join(c.REPO, PKG), os.path.join(dst, PKG),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(c.REPO, "chip_smoke.py"), dst)
            cu = os.path.join(dst, PKG, source if "/" in source else os.path.join("csrc", source))
            with open(cu) as f:
                src = f.read()
            for old, new in (spec if not spec or isinstance(spec[0], tuple) else (spec,)):
                c.check(src.count(old) == 1, f"mutant {name}: the line to break is not in {source} once")
                src = src.replace(old, new)
            with open(cu, "w") as f:
                f.write(src)
            out = subprocess.run([sys.executable, "-c", probe], cwd=dst, capture_output=True, text=True)
            lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                     if ln.startswith(("[mutant]", "[variant]", "FAILED"))]
            c.log(f"[mutants] {name}: exit {out.returncode}; " + " | ".join(lines))
            all_failed &= out.returncode != 0
    return all_failed


def variants() -> None:
    """Kernel 2 as kept beside the designs of PCG_VARIANTS, each built in a
    temporary copy: grid, iterations, device ms, µs per iteration and the
    prologue at 861 and 2600 points."""
    mutants("block_pcg.cu", {"kept": (), **PCG_VARIANTS}, VARIANT_PROBE)


def extract_parent(path) -> None:
    """The warm extraction of a full-width frame (CUDA events, median of 20,
    and its CUDA launches) in another checkout ``path`` (e.g. ``git archive``
    of the parent commit unpacked into ``build/parent``) and in this tree,
    alternated: other, this, this, other; one process each."""
    for label, cwd in (("other", path), ("this", c.REPO), ("this", c.REPO), ("other", path)):
        out = subprocess.run([sys.executable, "-c", EXTRACT_PROBE], cwd=cwd, capture_output=True, text=True)
        lines = [ln for ln in (out.stdout + out.stderr).splitlines() if ln.startswith(("[extract]", "Traceback"))]
        c.log(f"[extract_parent] {label} tree ({cwd}): " + " | ".join(lines))


def rounding():
    import torch

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    spec = deformable.MODELS[sc.sweep_config().opt_model]
    kernel = block_pcg.pcg_block_system
    plain = lambda *args: block_pcg.pcg_block_system_plain(*args)[0]
    dbl = lambda nt: type(nt)(*(v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
                                for v in nt))
    for n in (c.BIGN_POINTS, c.LARGE_POINTS):
        data, state, hyper = c._first_problem(n)
        cpu = tuple(c._on_cpu(t) for t in (data, hyper, state))
        ways = (("cuda-kernel", (data, hyper, state), kernel), ("cuda-plain", (data, hyper, state), plain),
                ("cpu", cpu, kernel), ("cpu-f64", tuple(dbl(t) for t in cpu), kernel))
        for its in range(1, 11):
            out = []
            for label, args, solver in ways:
                block_pcg.pcg_block_system = solver
                try:
                    r = deformable.solve_pair("KB8", *args, its, spec)
                finally:
                    block_pcg.pcg_block_system = kernel
                out.append(f"{label}: acc={r.n_accepted} sol={r.n_solves} lam={float(r.lam):.6e} "
                           f"cost={float(r.cost):.6e}")
            c.log(f"[rounding] {n} points, {its} iterations | " + " | ".join(out))


def chol_profile(dims=(377, 1448, 2591, 4096), reps=20):
    """Kernel 1's CUDA launches under ``torch.profiler`` over ``reps`` solves
    of chip_smoke.py's synthetic system at each dim: launches and device
    time per solve for each CUDA kernel name, and CUDA events around one
    solve (median of 30) beside them."""
    import torch

    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    for dim in dims:
        H, g, lam = c.make_system(dim, seed=dim)
        H, g = torch.as_tensor(H, device="cuda"), torch.as_tensor(g, device="cuda")
        lam = torch.tensor(lam, dtype=torch.float32, device="cuda")
        solve = lambda: dc.damped_solve_cuda(H, g, lam)
        event_ms = c.time_ms(solve)
        rows = sorted(((k, n / reps, n * ms / reps) for k, (n, ms) in c.device_launches(solve, reps).items()),
                      key=lambda r: -r[2])
        c.log(f"[chol_profile] dim={dim} events_ms={event_ms:.4f} device_ms={sum(r[2] for r in rows):.4f} "
              f"launches_per_solve={sum(r[1] for r in rows):g} | "
              + " | ".join(f"{k}: {n:g} x, {ms:.4f} ms" for k, n, ms in rows))
        phases = chol_phases(H, g, lam, reps)
        nb = -(-dim // 32)
        c.log(f"[chol_phases] dim={dim} panels={nb} median ms of {reps} solves: "
              + " ".join(f"{k}={v:.4f}" for k, v in phases.items())
              + f" us_per_panel={1e3 * phases['factorization'] / nb:.2f}")


def chol_parity(source):
    """Kernel 1 against another version of its source (``source``: a
    damped_cholesky.cu with the same C entry points, e.g. from ``git show
    REV:triangulation_in_deformable_scenes_torch/csrc/damped_cholesky.cu``),
    built into a library of its own: the output entries that differ bit for
    bit on chip_smoke.py's synthetic systems, the main path's first system
    and the condition-1e6 one."""
    import ctypes

    import torch

    from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import _nvcc, lm
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libother.so")
        subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-shared", "-o", lib_path, source],
                       check=True, capture_output=True)
        other = ctypes.CDLL(lib_path)
    vp = ctypes.c_void_p
    other.tids_damped_solve.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp]
    other.tids_damped_solve_pad.argtypes = [ctypes.c_int]

    cases = []
    for dim in (1, 33, 100, 377, 728, 746, 1448, 2591):
        H, g, lam = c.make_system(dim, seed=dim)
        cases.append((f"synthetic {dim}", torch.as_tensor(H, device="cuda"), torch.as_tensor(g, device="cuda"), lam))
    data, state, hyper = c._first_problem(240)
    H, g = deformable.build_system("KB8", data, hyper, state, deformable.MODELS[sc.sweep_config().opt_model])
    cases.append(("main path 1448", H, g, float(lm.TAU * H.diagonal().max())))
    H, g = c.make_ill_conditioned(1448, c.ILL_COND, seed=7)
    cases.append(("condition 1e6, 1448", H, g, 0.0))
    for label, H, g, lam in cases:
        x, (xo, _) = dc.damped_solve_cuda(H, g, lam), c.chol_call(other, "tids_damped_solve", H, g, lam)
        torch.cuda.synchronize()
        c.log(f"[chol_parity] {label}: {int((x != xo).sum())} of {x.numel()} entries differ, "
              f"max |diff| / max |x| {float((x - xo).abs().max() / xo.abs().max()):.3e}")


CHOL_PHASES = ("set-up", "factorization", "backward_1", "residual", "solve_pair_2")


def chol_phases(H, g, lam, reps):
    """Median time (ms) of each phase of kernel 1's one launch, from the
    globaltimer stamps that block 0 writes at the phase ends
    (``tids_damped_solve_timed``), and their sum."""
    import statistics

    import torch

    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc

    stamps = torch.zeros(len(CHOL_PHASES) + 1, dtype=torch.int64, device=H.device)
    spans = []
    for _ in range(reps + 1):
        c.chol_call(dc._load(), "tids_damped_solve_timed", H, g, lam, stamps.data_ptr())
        spans.append(torch.diff(stamps).cpu().tolist())
    spans = spans[1:]
    out = {name: statistics.median(s[i] for s in spans) / 1e6 for i, name in enumerate(CHOL_PHASES)}
    out["total"] = statistics.median(sum(s) for s in spans) / 1e6
    return out


def pcg_profile(points=(c.LARGE_POINTS, c.BIGN_POINTS), reps=20):
    """Kernel 2 on the large-N path's first systems: the grid, CUDA events
    around the wrapper and device time (profiler) of the one-iteration solve
    at CG_ITERS / CG_RTOL and of the tight solve, and both launches split
    into phases; the difference of the two over their iterations is the
    split of one iteration."""
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    for n in points:
        sys_, nbr, b, lam = c._block_problem(n)
        runs = {}
        for label, its, rtol in (("path", deformable.CG_ITERS, deformable.CG_RTOL),
                                 ("tight", c.PCG_TIGHT_CAP, c.PCG_TIGHT_RTOL)):
            solve = lambda: block_pcg.pcg_block_system_cuda(sys_, nbr, b, lam, its, rtol)
            event_ms = c.time_ms(solve)
            launches = c.device_launches(solve, reps)
            device_ms = sum(cnt * ms for cnt, ms in launches.values()) / reps
            per_solve = sum(cnt for cnt, _ in launches.values()) / reps
            phases, k = c.pcg_phases(sys_, nbr, b, lam, its, rtol, reps)
            runs[label] = (phases, k)
            c.log(f"[pcg_profile] N={n} dim={6 * n + 8} {label}: grid={block_pcg._load().tids_pcg_grid(n, nbr.shape[1])} "
                  f"iterations={k} events_ms={event_ms:.4f} device_ms={device_ms:.4f} "
                  f"launches_per_solve={per_solve:g} ({', '.join(launches)}) | phases (median ms of {reps}): "
                  + " ".join(f"{name}={v:.5f}" for name, v in phases.items()))
        (p1, k1), (pt, kt) = runs["path"], runs["tight"]
        d = max(kt - k1, 1)
        c.log(f"[pcg_profile] N={n} one iteration ({kt} - {k1} iterations): "
              + " ".join(f"{name}_us={1e3 * (pt[name] - p1[name]) / d:.3f}" for name in (*c.PCG_PHASES, "total")))


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    c.kernel_phase()
    for _ in range(2):
        c.main_path_phase()
    for _ in range(2):
        c.large_main_phase()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(10, device="cuda").sum()
        torch.cuda.synchronize()
    c.log("[profiler] after one torch.profiler session:")
    c.main_path_phase()
    c.large_main_phase()


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_diagnostics.py runs on an NVIDIA card only", file=sys.stderr)
        return 3
    which = argv or ["mutants", "match_mutants", "chol_mutants", "chol_profile", "pcg_profile", "rounding", "profiler"]
    c.setup()
    ok = True
    for name in which:
        if name == "mutants":
            ok &= mutants()
        elif name == "match_mutants":
            ok &= mutants("match_scan.cu", MATCH_MUTANTS, MATCH_PROBE)
        elif name == "chol_mutants":
            ok &= mutants("damped_cholesky.cu", CHOL_MUTANTS, CHOL_PROBE)
        elif name == "halo_mutants":
            for source, table in HALO_MUTANTS.items():
                ok &= mutants(source, table, HALO_PROBE)
        elif name == "rounding":
            rounding()
        elif name == "profiler":
            profiler()
        elif name == "chol_profile":
            chol_profile()
        elif name == "pcg_profile":
            pcg_profile()
        elif name == "pcg_variants":
            variants()
        elif name.startswith("extract_parent="):
            extract_parent(name.split("=", 1)[1])
        elif name.startswith("chol_parity="):
            chol_parity(name.split("=", 1)[1])
        else:
            print(f"unknown diagnostic {name!r}", file=sys.stderr)
            return 2
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
