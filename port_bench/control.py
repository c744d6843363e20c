"""Readings of the output check's numbers on many seeds, in one process.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...] [--no-control] [--out FILE]

For each seed it takes what a run of the cell would check (the sweep: the
seed's first condition, or with ``--first`` that condition's first inner
solve alone; the batch: the seed's first batch), runs the program on it
without a window, runs the plain reference, and prints the numbers the
check compares: the program against the reference (the lower
readings of each limit), and the control against the reference (the
upper readings). The control is the reference put in the program's place
with float32 matrix products in TF32, the nearest precision below the
configuration's float32 with TF32 off. One JSON line per seed; with
``--out`` also appended to FILE.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _first_solve(cfg, cond, device):
    """The program's and the reference's first inner solve of ``cond``
    (the pipeline up to its first ``solve_pair``, at the starting weights):
    the program's (valid, initial, first) against a reference
    ``ConditionResult`` holding only those."""
    import torch

    from port_bench.drivers import batch
    from port_bench.reference import pipeline as ref_pipeline
    from port_bench.reference import solver as ref_solver
    from triangulation_in_deformable_scenes_torch.models import deformable

    data, state = batch.program_pair(cfg, device, cond)
    rep, arap, sigma = batch.start_weights(cfg)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    hyper = deformable.Hyper(rep_w=f(rep), arap_w=f(arap), depth_sigma=f(sigma), global_w=f(1.0), alpha=f(1.0),
                             beta=f(1.0))
    res = deformable.solve_pair("KB8", data, hyper, state, cfg["lm_iterations"], deformable.MODELS[cfg["model"]])
    ours = (data.valid.cpu().numpy(), state, res.state)

    def reference():
        rdata, rstate, _, valid, _ = ref_pipeline.first_problem(cfg, cond.c2_pose, cond.orig, cond.moved,
                                                                cond.noise_seed, device)
        r = ref_solver.solve_pair(rdata, ref_solver.Hyper(rep_w=f(rep), arap_w=f(arap), depth_sigma=f(sigma)),
                                  rstate, cfg["lm_iterations"])
        return valid, rstate, r.state

    return ours, reference


def readings(cell, seed: int, device, control: bool = True, first_only: bool = False) -> dict:
    import numpy as np

    from port_bench import gen
    from port_bench.drivers import batch, sweep
    from port_bench.reference import pipeline as ref_pipeline
    from port_bench.reference import precision

    cfg, traffic = cell.config, cell.traffic
    out = {"seed": seed}
    t = time.perf_counter()
    if traffic["driver"] == "sweep" and first_only:
        cond = gen.conditions(cfg, traffic, seed, 1)[0]
        ours, reference = _first_solve(cfg, cond, device)
        out["program_s"] = time.perf_counter() - t
        np_ = lambda x: x.detach().cpu().double().numpy()

        def nums(a, b):
            v = np.asarray(b[0], dtype=bool)
            gap = lambda x, y: float(max(np.abs(np_(x.p1) - np_(y.p1))[v].max(), np.abs(np_(x.p2) - np_(y.p2))[v].max()))
            return {"valid_diff": float(np.sum(np.asarray(a[0], dtype=bool) != v)),
                    "init_gap_m": gap(a[1], b[1]), "first_gap_m": gap(a[2], b[2])}

        t = time.perf_counter()
        with precision(tf32=False):
            ref = reference()
        out["reference_s"] = time.perf_counter() - t
        out.update(condition=cond.label, program=nums(ours, ref))
        if control:
            with precision(tf32=True):
                out["control"] = nums(reference(), ref)
    elif traffic["driver"] == "sweep":
        from triangulation_in_deformable_scenes_torch.models import deformable, outer

        cond = gen.conditions(cfg, traffic, seed, 1)[0]
        with tempfile.TemporaryDirectory() as tmp:
            files = gen.write_fixture(tmp, cond)
            seen = {}
            optimize0, solve0 = outer.deformation_optimization, deformable.solve_pair

            def optimize(*args, **kwargs):
                seen["x"] = (args[8], args[9])
                return optimize0(*args, **kwargs)

            def solve(*args, **kwargs):
                res = solve0(*args, **kwargs)
                seen.setdefault("first", res.state)
                return res

            outer.deformation_optimization, deformable.solve_pair = optimize, solve
            try:
                res = sweep.run_condition(cfg, device, cond, files)
            finally:
                outer.deformation_optimization, deformable.solve_pair = optimize0, solve0
        out["program_s"] = time.perf_counter() - t
        ours = (*seen["x"], seen["first"], res.state, np.asarray(res.weights, dtype=np.float64), res.rounds)
        t = time.perf_counter()
        with precision(tf32=False):
            ref = ref_pipeline.run_condition(cfg, cond.c2_pose, cond.orig, cond.moved, cond.noise_seed, device)
        out["reference_s"] = time.perf_counter() - t
        out.update(condition=cond.label, rounds=res.rounds, weight=float(res.weights[2]),
                   inner_solves=res.stats.inner_solves, program=sweep.numbers(ours, ref, cond))
        if control:
            with precision(tf32=True):
                ctl = ref_pipeline.run_condition(cfg, cond.c2_pose, cond.orig, cond.moved, cond.noise_seed, device)
            out["control"] = sweep.numbers((ctl.valid, ctl.initial, ctl.first, ctl.final, ctl.weights, ctl.rounds),
                                           ref, cond)
    else:
        import torch

        from triangulation_in_deformable_scenes_torch.models import deformable
        from triangulation_in_deformable_scenes_torch.ops import lm

        conds = gen.conditions(cfg, traffic, seed, traffic["batch"])
        pairs = [batch.program_pair(cfg, device, c) for c in conds]
        data, state = lm.stack([d for d, _ in pairs]), lm.stack([s for _, s in pairs])
        rep, arap, sigma = batch.start_weights(cfg)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        hyper = deformable.Hyper(rep_w=f(rep), arap_w=f(arap), depth_sigma=f(sigma), global_w=f(1.0), alpha=f(1.0),
                                 beta=f(1.0))
        res = deformable.solve_pairs("KB8", data, hyper, state, cfg["lm_iterations"], deformable.MODELS[cfg["model"]])
        out["program_s"] = time.perf_counter() - t
        t = time.perf_counter()
        with precision(tf32=False):
            refs = batch.reference_pairs(cfg, conds, device)
        out["reference_s"] = time.perf_counter() - t
        out["program"] = batch.numbers(batch.program_pairs(state, res), refs)
        if control:
            with precision(tf32=True):
                ctl = batch.reference_pairs(cfg, conds, device)
            out["control"] = batch.numbers([(r0, r.state, r.cost) for _, r0, r in ctl], refs)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--first", action="store_true", help="sweep cells: the first inner solve alone")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from port_bench import bench

    cell = bench.load_cell(ROOT, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        line = json.dumps(dict(readings(cell, seed, device, not args.no_control, args.first), workload=args.workload))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
