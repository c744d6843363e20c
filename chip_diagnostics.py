#!/usr/bin/env python3
"""Diagnostics of the torch port on one NVIDIA card, beside chip_smoke.py.
They print readings and check only what is stated; PERF.md cites them.

    python3 chip_diagnostics.py [mutants] [match_mutants] [rounding] [profiler]

(no argument runs all four)

- ``mutants``: copies the package and chip_smoke.py into a temporary
  directory, removes one term of ``csrc/block_pcg.cu`` there (the neighbour
  products, the point-to-global coupling in the point rows or in the global
  rows, Hg, the preconditioner), and prints for each the tight-solve
  residuals of chip_smoke.py's two right-hand sides and the check of
  ``chip_smoke.pcg_case(861)`` that fails. Exits non-zero if a broken
  kernel passes that phase.
- ``match_mutants``: the same for kernel 3, ``csrc/match_scan.cu``: the
  last occurrence winning a tie, a displaced best not becoming the second,
  no window test, no octave gate, no column validity, no row flag; each must
  fail ``chip_smoke.match_phase()``.
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
    "no_neighbours": ("acc[r] += blk[r * 6 + c] * v[c];", "acc[r] += 0.0f * v[c];"),
    "no_C_in_point_rows": ("y += Cr[g] * pg[g];", "y += 0.0f * pg[g];"),
    "no_C_in_global_rows": ("ct += Cc[c * 8] * pv[c];", "ct += 0.0f * pv[c];"),
    "no_Hg": ("acc += a.Hg[g * 8 + h] * pg[h];", "acc += 0.0f * pg[h];"),
    "no_preconditioner": (
        "if (lane == 0) inv_spd<6>(a.D + (size_t)i * 36, lam, a.Dinv + (size_t)i * 36);",
        "for (int e = lane; e < 36; e += 32) a.Dinv[(size_t)i * 36 + e] = (e % 7 == 0) ? 1.0f : 0.0f;",
    ),
}
MATCH_MUTANTS = {
    "last_occurrence": ("if (D < best) {", "if (D <= best) {"),
    "second_not_displaced": ("        second = best;\n        best = D;", "        best = D;"),
    "no_window": ("d2 <= rr && ", ""),
    "no_octave_gate": ("oc >= o - 1 && oc <= o + 1", "true"),
    "no_column_validity": ("s_valid[t] && ", ""),
    "no_row_flag": ("    if (!ok) continue;", ""),
}
MATCH_PROBE = "import chip_smoke as c\nc.setup()\nc.match_phase()\n"
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
    """Each broken kernel must fail its probe (kernel 2: chip_smoke.pcg_case(861))."""
    all_failed = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, (old, new) in table.items():
            dst = os.path.join(tmp, name)
            shutil.copytree(os.path.join(c.REPO, PKG), os.path.join(dst, PKG),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(c.REPO, "chip_smoke.py"), dst)
            cu = os.path.join(dst, PKG, "csrc", source)
            with open(cu) as f:
                src = f.read()
            c.check(src.count(old) == 1, f"mutant {name}: the line to break is not in {source} once")
            with open(cu, "w") as f:
                f.write(src.replace(old, new))
            out = subprocess.run([sys.executable, "-c", probe], cwd=dst, capture_output=True, text=True)
            lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                     if ln.startswith(("[mutant]", "FAILED"))]
            c.log(f"[mutants] {name}: exit {out.returncode}; " + " | ".join(lines))
            all_failed &= out.returncode != 0
    return all_failed


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
    which = argv or ["mutants", "match_mutants", "rounding", "profiler"]
    c.setup()
    ok = True
    for name in which:
        if name == "mutants":
            ok &= mutants()
        elif name == "match_mutants":
            ok &= mutants("match_scan.cu", MATCH_MUTANTS, MATCH_PROBE)
        elif name == "rounding":
            rounding()
        elif name == "profiler":
            profiler()
        else:
            print(f"unknown diagnostic {name!r}", file=sys.stderr)
            return 2
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
