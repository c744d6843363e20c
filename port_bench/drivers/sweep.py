"""The sweep: synthetic conditions one at a time, in a closed loop, through
the port's ``pipeline.simulation.SimulationPipeline.run``.

Set-up draws ``conditions_in_setup`` conditions from the seed
(``gen.conditions``), writes their point files under TMPDIR, and runs the
first one through the whole pipeline at a budget of one round, one search
evaluation and one LM iteration (the rigid selection too): that builds the
kernels and reaches every shape and host code path the window uses.

The window opens when the first condition starts. Every inner solve the
outer search issues (one ``outer.SolveStats.add``: a deformable or a rigid
LM solve) is counted as it completes; the window closes at the first of
those boundaries at or after ``--seconds``, after a synchronize, and the
condition then in flight is abandoned, unless no condition has completed:
then that first one runs on past the close, untimed, so that the check has
an answer. ``solve_ms`` is the window over the inner solves completed in it.

The check draws one of the conditions the window completed from the seed
and runs the plain reference on the same raw inputs (the ground-truth
points, the noise seed, the configuration).

With ``--trace 1`` the assembly, damped-solve and cost calls are
synchronized spans, and two stretches are profiled: the window's first
deformable inner solve and its first rigid selection (``rigid.solve_rigid``).
The time spent starting, stopping and reducing the profiler is taken out of
the window and out of its deadline.
"""

from __future__ import annotations

import dataclasses
import math
import time
import numpy as np
import torch

from .. import gen, roofline
from .. import trace as trace_mod
from ..reference import pipeline as ref_pipeline
from . import Out, WindowClosed
from ..reference import precision


def program_config(cfg: dict, cond, budget=None):
    """The port's ``Config`` for ``cond``; ``budget`` (rounds, evaluations,
    iterations) replaces the configuration's."""
    from triangulation_in_deformable_scenes_torch.config import Config

    rounds, evals, iters = budget or (cfg["rounds"], cfg["nm_evaluations"], cfg["lm_iterations"])
    fx, fy, cx, cy, *d = cfg["kb8"]
    wb = cfg["weight_bounds"]
    return Config(
        fx=fx, fy=fy, cx=cx, cy=cy, d=tuple(d), min_cos=cfg["min_cos"],
        c1_pose=tuple(cfg["c1_pose"]), c2_pose=tuple(cond.c2_pose),
        sim_rep_error=cfg["pixel_noise_px"], decimals_rep_error=cfg["pixel_decimals"],
        sim_depth_error=cfg["depth_noise_mm"], sim_depth_weight=cfg["depth_weight_mm"],
        sim_depth_scale_c1=1.0, sim_depth_scale_c2=1.0,
        opt_rep_weight=cfg["start_weights"][0], opt_global_weight=cfg["start_weights"][1],
        opt_arap_weight=cfg["start_weights"][2], opt_alpha_weight=1.0, opt_beta_weight=1.0,
        opt_selection="twoOptimizations", opt_model=cfg["model"], opt_weights_selection="nlopt",
        triangulation_method=cfg["triangulation_method"], triangulation_location=cfg["triangulation_location"],
        n_optimizations=rounds, n_opt_iterations=iters, nlopt_n_optimizations=evals,
        nlopt_rel_tolerance=cfg["nlopt_xtol_rel"], nlopt_abs_tolerance=cfg["nlopt_xtol_abs"],
        nlopt_rep_lower=wb["rep"][0], nlopt_rep_upper=wb["rep"][1],
        nlopt_global_lower=wb["global"][0], nlopt_global_upper=wb["global"][1],
        nlopt_arap_lower=wb["arap"][0], nlopt_arap_upper=wb["arap"][1],
    )


@dataclasses.dataclass
class State:
    conds: list
    files: list


def run_condition(cfg, device, cond, files, budget=None):
    """The program's ``SimulationPipeline.run`` of ``cond``."""
    from triangulation_in_deformable_scenes_torch.pipeline.simulation import SimulationPipeline

    pipe = SimulationPipeline(program_config(cfg, cond, budget), seed=cond.noise_seed,
                              mesh_backend="scipy", device=device)
    return pipe.run(*files, journal_path=f"{files[0]}.journal")


def setup(ctx) -> State:
    """The seed's conditions and their files; the warm-up condition runs the
    rigid selection at one LM iteration and one restart (the pipeline asks
    for at least 30 iterations), which reaches its shapes as well."""
    from triangulation_in_deformable_scenes_torch.models import rigid

    conds = gen.conditions(ctx.cfg, ctx.traffic, ctx.seed, ctx.traffic["conditions_in_setup"])
    files = [gen.write_fixture(ctx.tmp, c) for c in conds]
    solve_rigid = rigid.solve_rigid
    rigid.solve_rigid = lambda cam, data, hyper, state, n, spec, stats=None: solve_rigid(
        cam, data, hyper, state, 1, spec, max_restarts=1, stats=stats)
    try:
        run_condition(ctx.cfg, ctx.device, conds[0], files[0], budget=(1, 1, 1))
    finally:
        rigid.solve_rigid = solve_rigid
    return State(conds, files)


def _targets():
    from triangulation_in_deformable_scenes_torch.models import block_system, deformable, rigid
    from triangulation_in_deformable_scenes_torch.ops import block_pcg, lm

    spans = [(deformable, "build_system", "assembly"), (block_system, "build_block_system", "assembly"),
             (rigid, "build_system_rigid", "assembly"), (lm, "solve_damped_cholesky", "solve"),
             (block_pcg, "pcg_block_system", "solve"), (deformable, "robust_cost", "cost"),
             (rigid, "robust_cost_rigid", "cost")]
    kernels = [(lm, "solve_damped_cholesky", "kernel1", lambda H, g, lam: roofline.damped_solve_s(H.shape[0])),
               (block_pcg, "pcg_block_system", "kernel2",
                lambda sys, nbr, *a, **k: roofline.block_pcg_s(nbr.shape[0], nbr.shape[1]))]
    return spans, kernels


def window(ctx, st: State) -> Out:
    from triangulation_in_deformable_scenes_torch.models import deformable, outer, rigid
    from triangulation_in_deformable_scenes_torch.ops import block_pcg, damped_cholesky

    live = dict(solves=0, trials=0, iterations=0, failed=0, closed=False, current=0, completed=0)
    started = {}
    add0 = outer.SolveStats.add
    optimize0 = outer.deformation_optimization
    tr = None
    if ctx.trace:
        tr = trace_mod.Trace(*_targets())
        tr.install()
    launches0 = damped_cholesky.LAUNCHES + block_pcg.LAUNCHES

    def close():
        ctx.sync()
        if tr is not None:
            if tr.profiling:
                tr.end_stretch("cut at the close")
            tr.active = False
        live["t_close"] = time.perf_counter()
        live["closed"] = True
        live["launches"] = damped_cholesky.LAUNCHES + block_pcg.LAUNCHES - launches0

    def add(self, res, rigid=False):
        add0(self, res, rigid)
        if live["closed"]:
            return
        live["solves"] += 1
        live["trials"] += int(res.n_solves)
        live["iterations"] += int(res.n_accepted)
        live["failed"] += int(not bool(torch.isfinite(res.cost)))
        if time.perf_counter() - live["t_open"] - (tr.overhead_s if tr else 0.0) >= ctx.seconds:
            close()
            if live["completed"] > 0:
                raise WindowClosed

    def optimize(*args, **kwargs):
        started[live["current"]] = [args[8], args[9], None]  # valid, initial state, first solve's state
        return optimize0(*args, **kwargs)

    def first_solve(*args, **kwargs):
        res = solve_pair0(*args, **kwargs)
        if started[live["current"]][2] is None:
            started[live["current"]][2] = res.state
        return res

    def profiled(fn, label, seen):
        def wrapper(*args, **kwargs):
            if seen or not tr.active or tr.profiling:
                return fn(*args, **kwargs)
            seen.append(True)
            tr.begin_stretch()
            try:
                return fn(*args, **kwargs)
            finally:
                if tr.profiling:
                    tr.end_stretch(label)
        return wrapper

    solve_pair0 = deformable.solve_pair
    patches = [(outer.SolveStats, "add", add), (outer, "deformation_optimization", optimize),
               (deformable, "solve_pair", first_solve)]
    if tr is not None:
        patches += [(deformable, "solve_pair", profiled(first_solve, "first deformable inner solve", [])),
                    (rigid, "solve_rigid", profiled(rigid.solve_rigid, "first rigid selection", []))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    done = []
    try:
        ctx.sync()
        live["t_open"] = time.perf_counter()
        if tr is not None:
            tr.active = True
        try:
            for k, (cond, files) in enumerate(zip(st.conds, st.files)):
                live["current"] = k
                res = run_condition(ctx.cfg, ctx.device, cond, files)
                done.append((cond, res, started[k]))
                live["completed"] += 1
                if live["closed"]:
                    break
            if not live["closed"]:
                raise RuntimeError(f"{len(st.conds)} conditions ended before {ctx.seconds} s: "
                                   "set-up must generate more")
        except WindowClosed:
            pass
    finally:
        for obj, name, fn in reversed(originals):
            setattr(obj, name, fn)
        if tr is not None:
            tr.uninstall()

    window_s = live["t_close"] - live["t_open"] - (tr.overhead_s if tr else 0.0)
    record = {"kind": "sweep", "window_s": window_s, "inner_solves": live["solves"], "lm_solves": live["trials"]}
    if tr is not None:
        calls = tr.span_calls
        launched = live["launches"] if ctx.device.type == "cuda" else live["trials"]
        if not (calls["solve"] == live["trials"] == launched
                and calls["cost"] == live["trials"] + live["solves"]
                and live["iterations"] <= calls["assembly"] <= live["iterations"] + live["solves"]):
            raise RuntimeError(f"span calls {dict(calls)} disagree with the program's counters: "
                               f"{live['solves']} inner solves, {live['trials']} trials, "
                               f"{live['iterations']} accepted iterations, {live['launches']} kernel launches")
        record.update(span_s=dict(tr.span_s), span_calls=dict(calls), summary=trace_mod.summary(tr))
    pick = np.random.default_rng([ctx.seed, 7]).integers(len(done))
    return Out(metrics={"solve_ms": 1e3 * window_s / live["solves"]}, attempted=live["solves"],
               failed=live["failed"], record=record, sample=done[pick])


def numbers(ours, ref, cond) -> dict:
    """Program against reference on one condition. ``ours``: the valid mask,
    the initial state, the first inner solve's and the final state, the
    weights and the rounds."""
    valid, init, first, final, weights, rounds = ours
    v = np.asarray(ref.valid, dtype=bool)
    np_ = lambda t: t.detach().cpu().double().numpy()

    def gap(a, b):
        if not v.any():
            return math.inf
        return float(max(np.abs(np_(a.p1) - np_(b.p1))[v].max(), np.abs(np_(a.p2) - np_(b.p2))[v].max()))

    def err(s):
        e1 = np.linalg.norm(np_(s.p1)[v] - cond.orig[v], axis=-1)
        e2 = np.linalg.norm(np_(s.p2)[v] - cond.moved[v], axis=-1)
        return float((e1.sum() + e2.sum()) / (2 * max(v.sum(), 1)))

    e_ref = err(ref.final)
    return {
        "valid_diff": float(np.sum(np.asarray(valid, dtype=bool) != v)),
        "init_gap_m": gap(init, ref.initial),
        "first_gap_m": gap(first, ref.first),
        "final_gap_m": gap(final, ref.final),
        "final_err_rel": abs(err(final) - e_ref) / max(e_ref, 1e-12),
        "weight_gap_log10": float(np.max(np.abs(np.log10(np.maximum(weights, 1e-300))
                                                - np.log10(np.maximum(ref.weights, 1e-300))))),
        "rounds_diff": float(abs(rounds - ref.rounds)),
    }


def check(ctx, st: State, out: Out) -> dict:
    cond, res, (valid, init, first) = out.sample
    ours = (valid, init, first, res.state, np.asarray(res.weights, dtype=np.float64), res.rounds)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with precision(tf32=False):
        ref = ref_pipeline.run_condition(ctx.cfg, cond.c2_pose, cond.orig, cond.moved, cond.noise_seed, ctx.device)
    return numbers(ours, ref, cond)
