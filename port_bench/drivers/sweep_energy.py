"""The sweep of ``sweep.py`` for a configuration whose mesh energy is not
ARAP's (``reference/energies.MODEL``): the same set-up, window, record and
end-to-end metrics, and a check against ``reference/energies.py``.

The configuration states the energy's (alpha, beta); the program's
configuration (``sweep.program_config``) passes alpha = beta = 1, so
``setup`` refuses any other.

With ``--trace 1`` the program's own recording (``tracing``) is turned on when the window opens, after set-up, and
collected after the window into ``record["program"]``. The window opens
and closes where the benchmark's wrappers are switched on and off; the
close is stamped on the program's clock (``perf_counter_ns``), and
``record["program_window"]`` holds the calls and total seconds of the
spans ``assembly.mesh_jacobian`` and ``cost.mesh_energy`` that ended at or
before it, which the readers read. Where the program records those spans,
the run fails unless the window holds one of each for every deformable
assembly and cost the wrappers counted (theirs less the rigid model's).

Run as a module it prints the check's readings on many seeds, one JSON
line each, as ``control.py`` does for the ARAP cells: the program against
the reference, the control (the reference with TF32 matrix products)
against the reference, and how far the float32 edge energies of the
seed's first problem lie from a float64 evaluation of the same formula::

    python3 -m port_bench.drivers.sweep_energy --workload ogden240.sweep --seeds 1 2 3 [--condition K]
        [--no-control] [--out FILE]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import gen
from .. import trace as trace_mod
from ..reference import energies, precision
from . import sweep

SPANS = {"assembly": "assembly.mesh_jacobian", "cost": "cost.mesh_energy"}


def _refuse_other_parameters(cfg: dict):
    if cfg["model"] != energies.MODEL:
        raise ValueError(f"no reference energy for model {cfg['model']!r}")
    if (float(cfg["alpha"]), float(cfg["beta"])) != (1.0, 1.0):
        raise ValueError(f"alpha {cfg['alpha']}, beta {cfg['beta']}: the program's configuration passes 1 and 1")


def setup(ctx) -> sweep.State:
    _refuse_other_parameters(ctx.cfg)
    return sweep.setup(ctx)


def window(ctx, st: sweep.State):
    if not ctx.trace:
        return sweep.window(ctx, st)
    from triangulation_in_deformable_scenes_torch import tracing
    from triangulation_in_deformable_scenes_torch.models import rigid

    made = []
    rigid_calls = collections.Counter()

    class Marked(trace_mod.Trace):
        """The benchmark's wrappers, which also start the program's
        recording when the window opens and stamp its close."""

        def __init__(self, *args):
            self._on = False
            self.close_ns = None
            super().__init__(*args)
            made.append(self)

        @property
        def active(self):
            return self._on

        @active.setter
        def active(self, on):
            if on and not self._on:
                tracing.enable()
            elif self._on and not on:
                self.close_ns = time.perf_counter_ns()
            self._on = on

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            if made and made[0].active:
                rigid_calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    patches = [(trace_mod, "Trace", Marked), (rigid, "build_system_rigid", counted(rigid.build_system_rigid, "assembly")),
               (rigid, "robust_cost_rigid", counted(rigid.robust_cost_rigid, "cost"))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        out = sweep.window(ctx, st)
    finally:
        for obj, name, fn in reversed(originals):
            setattr(obj, name, fn)
        prog = tracing.collect()
    if prog:
        close = made[0].close_ns
        spans = {name: [t1 - t0 for nm, t0, t1, *_ in prog["raw"] if nm == name and t1 <= close]
                 for name in SPANS.values() if name in prog["spans"]}
        out.record.update(program=prog, program_window={
            name: {"calls": len(d), "total_s": sum(d) / 1e9} for name, d in spans.items()})
        if spans:
            for key, name in SPANS.items():
                want = out.record["span_calls"].get(key, 0) - rigid_calls[key]
                got = len(spans.get(name, ()))
                if got != want:
                    raise RuntimeError(f"{got} {name} spans in the window against {want} deformable {key} calls "
                                       f"(wrappers {dict(out.record['span_calls'])}, rigid {dict(rigid_calls)})")
    return out


def reference(cfg: dict, cond, device, tf32: bool = False):
    with precision(tf32=tf32):
        return energies.run_condition(cfg, cond.c2_pose, cond.orig, cond.moved, cond.noise_seed, device)


def check(ctx, st: sweep.State, out) -> dict:
    cond, res, (valid, init, first) = out.sample
    ours = (valid, init, first, res.state, np.asarray(res.weights, dtype=np.float64), res.rounds)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return sweep.numbers(ours, reference(ctx.cfg, cond, ctx.device), cond)


def f64_reading(cfg: dict, cond, device) -> dict:
    """The program's float32 edge energies [N, K] of ``cond``'s first
    problem against the same formula in float64 on the same inputs: the
    largest error over the largest energy, the largest relative error of an
    edge's Ogden term (the energy less its global term) among edges whose
    term is at least 1e-3 of the largest, and the median |lambda - 1|."""
    from triangulation_in_deformable_scenes_torch.models import deformable

    from .batch import program_pair

    data, state = program_pair(cfg, device, cond)
    one = torch.ones((), device=device)
    hyper = deformable.Hyper(rep_w=one, arap_w=one, depth_sigma=one, global_w=one, alpha=one * cfg["alpha"],
                             beta=one * cfg["beta"])
    spec = deformable.MODELS[cfg["model"]]
    e32 = deformable._arap_energies(data, state, spec, hyper).double()
    o32 = deformable._arap_energies(data, state, spec._replace(use_global=False), hyper).double()
    d = lambda t: t.double() if t.is_floating_point() else t
    s64 = state._replace(**{k: d(v) for k, v in state._asdict().items()})
    j = torch.clamp(data.nbr, min=0)
    args = (s64.p1[:, None, :], s64.p2[:, None, :], s64.p1[j], s64.p2[j], d(data.wcot), d(data.area))
    e64 = energies.edge_energy(*args, s64.Rg, s64.tg, float(cfg["alpha"]), float(cfg["beta"]))
    g64 = energies.edge_energy(*args[:4], torch.zeros_like(args[4]), args[5], s64.Rg, s64.tg, 1.0, 1.0)
    live = data.nbr_mask
    e64 = torch.where(live, e64, torch.zeros_like(e64))
    o64, o32 = (e64 - g64)[live], o32[live]
    big = o64.abs() >= 1e-3 * o64.abs().max()
    d1, d2 = s64.p1[:, None, :] - s64.p1[j], s64.p2[:, None, :] - s64.p2[j]
    lam = torch.linalg.norm(d2, dim=-1)[live] / torch.linalg.norm(d1, dim=-1)[live]
    return {"energy_err_rel": float((e32 - e64).abs().max() / e64.abs().max()),
            "ogden_term_err_rel": float(((o32 - o64).abs()[big] / o64.abs()[big]).max()),
            "stretch_dev_median": float((lam - 1.0).abs().median()), "edges": int(live.sum())}


def readings(cell, seed: int, device, control: bool = True, condition: int = 0) -> dict:
    """What a run of the cell with ``seed`` would check, from the seed's
    condition ``condition`` (a window completes conditions 0 and 1) run by
    the program without a window."""
    from triangulation_in_deformable_scenes_torch.models import deformable, outer

    cfg = cell.config
    _refuse_other_parameters(cfg)
    cond = gen.conditions(cfg, cell.traffic, seed, 1, first=condition)[0]
    out = {"seed": seed, "condition": cond.label}
    t = time.perf_counter()
    seen = {}
    optimize0, solve0 = outer.deformation_optimization, deformable.solve_pair

    def optimize(*args, **kwargs):
        seen["x"] = (args[8], args[9])
        return optimize0(*args, **kwargs)

    def solve(*args, **kwargs):
        res = solve0(*args, **kwargs)
        seen.setdefault("first", res.state)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        files = gen.write_fixture(tmp, cond)
        outer.deformation_optimization, deformable.solve_pair = optimize, solve
        try:
            res = sweep.run_condition(cfg, device, cond, files)
        finally:
            outer.deformation_optimization, deformable.solve_pair = optimize0, solve0
    out["program_s"] = time.perf_counter() - t
    ours = (*seen["x"], seen["first"], res.state, np.asarray(res.weights, dtype=np.float64), res.rounds)
    t = time.perf_counter()
    ref = reference(cfg, cond, device)
    out["reference_s"] = time.perf_counter() - t
    out.update(rounds=res.rounds, weight=float(res.weights[2]), inner_solves=res.stats.inner_solves,
               program=sweep.numbers(ours, ref, cond))
    if control:
        ctl = reference(cfg, cond, device, tf32=True)
        out["control"] = sweep.numbers((ctl.valid, ctl.initial, ctl.first, ctl.final, ctl.weights, ctl.rounds),
                                       ref, cond)
    out["f64"] = f64_reading(cfg, cond, device)
    return out


def main(argv=None):
    from .. import bench

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--condition", type=int, default=0, help="which of the seed's conditions")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cell = bench.load_cell(root, args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        line = json.dumps(dict(readings(cell, seed, device, not args.no_control, args.condition), workload=args.workload))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
