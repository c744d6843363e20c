"""The serving batch: independent pairs refined together through the port's
``models.deformable.solve_pairs``, batch after batch in a closed loop.

Each pair is a sweep condition's first inner solve: the pipeline's own
steps up to its first ``solve_pair`` (observations, triangulation, initial
depth scales, mesh and frozen rotations) at the starting weights, with one
shared ``Hyper``. Set-up draws ``batches_in_setup`` batches of ``batch``
pairs from the seed (pair j of batch b is condition b * batch + j of
``gen.conditions``), stacks them, and runs one batch for two LM iterations,
which builds the kernels and reaches every shape of the window.

The window opens when the first batch starts and cycles the batches. It
closes at the first global step (one batched damped solve) at or after
``--seconds``, after a synchronize; the batch then in flight is abandoned.
``batch_pairs_per_s`` counts the pairs of the batches completed in the
window over the time from the opening to the end of the last of them.

The check draws one completed batch from the seed and solves each of its
pairs with the plain reference from the same raw inputs.

With ``--trace 1`` the per-pair assembly and cost calls and the batched
damped solve are synchronized spans, and the profiled stretch runs from the
end of the first batch's first damped solve to the end of its fourth: three
whole global steps. The time spent starting, stopping and reducing the
profiler is taken out of the window and out of its deadline.
"""

from __future__ import annotations

import dataclasses
import time
import numpy as np
import torch

from .. import gen, roofline
from .. import trace as trace_mod
from ..reference import pipeline as ref_pipeline
from . import Out, WindowClosed
from ..reference import precision
from ..reference import solver as ref_solver
from .sweep import program_config

STRETCH_STEPS = (1, 4)


@dataclasses.dataclass
class State:
    conds: list  # per batch: its conditions
    batches: list  # per batch: (stacked PairData, stacked PairState)
    hyper: object


def program_pair(cfg, device, cond):
    """The program's first problem of ``cond``: (PairData, PairState)."""
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.pipeline.simulation import SimulationPipeline

    pipe = SimulationPipeline(program_config(cfg, cond), seed=cond.noise_seed, mesh_backend="scipy",
                              device=device)
    rng = np.random.default_rng(cond.noise_seed)
    T1w, T2w = pipe._poses(cond.moved[0])
    kp1, kp2, d1, d2 = pipe._simulate_observations(cond.orig, cond.moved, T1w, T2w, rng)
    p1, p2, valid, _, _ = pipe._triangulate(kp1, kp2, T1w, T2w, d1, d2)
    s1, se1 = pipe._initial_depth_scale(p1, T1w, d1, valid)
    s2, se2 = pipe._initial_depth_scale(p2, T2w, d2, valid)
    data = deformable.make_pair_data(
        kp1, kp2, d1, d2, valid, pipe.cam_params, T1w, T2w, p1.cpu().numpy(), p2.cpu().numpy(),
        mesh_backend="scipy", scale_priors=(s1, 1.0 / max(se1, 1e-6) ** 2, s2, 1.0 / max(se2, 1e-6) ** 2),
        device=device,
    )
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    state = deformable.PairState(p1=p1, p2=p2, s1=f(s1), s2=f(s2), Rg=torch.eye(3, device=device),
                                 tg=torch.zeros(3, device=device))
    return data, state


def start_weights(cfg):
    """(rep, ARAP, depth sigma in m) of the first inner solve."""
    return cfg["start_weights"][0], cfg["start_weights"][2], cfg["depth_sigma_mm"] / 1000.0


def setup(ctx) -> State:
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import lm

    B = ctx.traffic["batch"]
    conds, batches = [], []
    for b in range(ctx.traffic["batches_in_setup"]):
        cs = gen.conditions(ctx.cfg, ctx.traffic, ctx.seed, B, first=b * B)
        pairs = [program_pair(ctx.cfg, ctx.device, c) for c in cs]
        ks = {int(d.nbr.shape[1]) for d, _ in pairs}
        if len(ks) != 1:
            raise ValueError(f"batch {b}: the pairs' meshes pad to different neighbour counts {sorted(ks)}")
        conds.append(cs)
        batches.append((lm.stack([d for d, _ in pairs]), lm.stack([s for _, s in pairs])))
    rep, arap, sigma = start_weights(ctx.cfg)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=ctx.device)
    hyper = deformable.Hyper(rep_w=f(rep), arap_w=f(arap), depth_sigma=f(sigma), global_w=f(ctx.cfg["start_weights"][1]),
                             alpha=f(1.0), beta=f(1.0))
    deformable.solve_pairs("KB8", batches[0][0], hyper, batches[0][1], 2, deformable.MODELS[ctx.cfg["model"]])
    return State(conds, batches, hyper)


def window(ctx, st: State) -> Out:
    from triangulation_in_deformable_scenes_torch.models import deformable
    from triangulation_in_deformable_scenes_torch.ops import damped_cholesky, lm

    B = ctx.traffic["batch"]
    spec = deformable.MODELS[ctx.cfg["model"]]
    live = dict(steps=0, started=0, closed=False)
    tr = None
    if ctx.trace:
        tr = trace_mod.Trace(
            [(deformable, "build_system", "assembly"), (lm, "solve_damped_cholesky_batched", "solve"),
             (deformable, "robust_cost", "cost")],
            [(lm, "solve_damped_cholesky_batched", "kernel1",
              lambda H, g, lam: roofline.damped_solve_batched_s(H.shape[0], H.shape[1]))])
        tr.install()
    solve0 = lm.solve_damped_cholesky_batched
    launches0 = damped_cholesky.LAUNCHES_BATCHED

    def step(H, g, lam):
        if time.perf_counter() - live["t_open"] - (tr.overhead_s if tr else 0.0) >= ctx.seconds:
            ctx.sync()
            if tr is not None:
                if tr.profiling:
                    tr.end_stretch("cut at the close")
                tr.active = False
            live["t_close"] = time.perf_counter()
            live["closed"] = True
            live["launches"] = damped_cholesky.LAUNCHES_BATCHED - launches0
            raise WindowClosed
        out = solve0(H, g, lam)
        live["steps"] += 1
        if tr is not None and live["started"] == 1:
            if live["steps"] == STRETCH_STEPS[0]:
                tr.begin_stretch()
            elif live["steps"] == STRETCH_STEPS[1] and tr.profiling:
                tr.end_stretch(f"global steps {STRETCH_STEPS[0] + 1}-{STRETCH_STEPS[1]} of the first batch")
        return out

    lm.solve_damped_cholesky_batched = step
    done = []
    try:
        ctx.sync()
        live["t_open"] = time.perf_counter()
        if tr is not None:
            tr.active = True
        k = 0
        try:
            while True:
                b = k % len(st.batches)
                live["started"] += 1
                res = deformable.solve_pairs("KB8", st.batches[b][0], st.hyper, st.batches[b][1],
                                             ctx.cfg["lm_iterations"], spec)
                ctx.sync()
                done.append((b, res, time.perf_counter()))
                k += 1
        except WindowClosed:
            pass
    finally:
        lm.solve_damped_cholesky_batched = solve0
        if tr is not None:
            tr.uninstall()
    if not done:
        raise RuntimeError(f"no batch completed within {ctx.seconds} s")
    span = done[-1][2] - live["t_open"]
    overhead = tr.overhead_s if tr else 0.0
    record = {"kind": "batch", "window_s": live["t_close"] - live["t_open"] - overhead, "global_steps": live["steps"],
              "batch": B}
    if tr is not None:
        c = tr.span_calls
        launched = live["launches"] if ctx.device.type == "cuda" else live["steps"]
        if not (c["solve"] == live["steps"] == launched and c["assembly"] == B * (live["steps"] + 1)
                and c["cost"] == B * (live["steps"] + live["started"])):
            raise RuntimeError(f"span calls {dict(c)} disagree with the program's counters: {live['steps']} "
                               f"global steps, {live['launches']} batched launches, {live['started']} batches")
        record.update(span_s=dict(tr.span_s), span_calls=dict(c), summary=trace_mod.summary(tr))
    failed = sum(int((~torch.isfinite(r.cost)).sum()) for _, r, _ in done)
    pick = done[np.random.default_rng([ctx.seed, 7]).integers(len(done))]
    return Out(metrics={"batch_pairs_per_s": B * len(done) / span}, attempted=B * len(done), failed=failed,
               record=record, sample=pick[:2])


def numbers(pairs, refs) -> dict:
    """Program against reference over one batch. ``pairs``: per pair
    (initial state, final state, final cost); ``refs``: per pair the
    reference's (valid, initial state, LMResult). The widest gap of any
    pair's initial and final points (m), and the widest and the median gap
    of a pair's final cost relative to the reference's."""
    np_ = lambda t: t.detach().cpu().double().numpy()

    def gap(a, b, v):
        return float(max(np.abs(np_(a.p1) - np_(b.p1))[v].max(), np.abs(np_(a.p2) - np_(b.p2))[v].max()))

    init_gap = final_gap = 0.0
    cost_rel = []
    for (init, final, cost), (v, r0, r) in zip(pairs, refs):
        v = np.asarray(v, dtype=bool)
        init_gap = max(init_gap, gap(init, r0, v))
        final_gap = max(final_gap, gap(final, r.state, v))
        c, cr = float(cost), float(r.cost)
        cost_rel.append(abs(c - cr) / max(abs(cr), 1e-30) if np.isfinite(c) else float("inf"))
    return {"init_gap_m": init_gap, "final_gap_m": final_gap, "final_cost_rel": max(cost_rel),
            "final_cost_rel_median": float(np.median(cost_rel))}


def program_pairs(init_batch, res) -> list:
    """``numbers``' per-pair view of a ``solve_pairs`` result."""
    from triangulation_in_deformable_scenes_torch.ops import lm

    return list(zip(lm.unstack(init_batch), lm.unstack(res.state), res.cost.unbind(0)))


def check(ctx, st: State, out: Out) -> dict:
    b, res = out.sample
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    with precision(tf32=False):
        refs = reference_pairs(ctx.cfg, st.conds[b], ctx.device)
    return numbers(program_pairs(st.batches[b][1], res), refs)


def reference_pairs(cfg, conds, device) -> list:
    """The reference's (valid, initial state, LMResult) of each pair."""
    rep, arap, sigma = start_weights(cfg)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    hyper = ref_solver.Hyper(rep_w=f(rep), arap_w=f(arap), depth_sigma=f(sigma))
    refs = []
    for c in conds:
        data, state, _, valid, _ = ref_pipeline.first_problem(cfg, c.c2_pose, c.orig, c.moved, c.noise_seed, device)
        refs.append((valid, state, ref_solver.solve_pair(data, hyper, state, cfg["lm_iterations"])))
    return refs
