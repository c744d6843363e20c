"""One synthetic condition of the plain reference, from the raw inputs to the
refined pair.

1. Cameras: camera 1 at ``c1_pose`` looking down +z, camera 2 at the
   condition's pose looking at the first moved point.
2. Observations: projections plus N(0, pixel noise) rounded to the stated
   decimals, depths z + N(0, depth noise), drawn from
   ``numpy.random.default_rng(noise_seed)`` in that order.
3. Triangulation by depth measurement with seeds in the rays; the parallax
   and positive-depth gate gives the valid mask.
4. Initial depth scales mean(d / z) with their standard errors as priors.
5. Rounds of a log10 Nelder-Mead search over the ARAP weight (round 1 opens
   with a probe of 8 stratified weights), every evaluation a full inner
   solve scored by the one-sided pixel discrepancy with an energy and
   displacement tie-break; the best weight's solve is the round's result;
   rounds stop when the objective no longer falls or the update is small.
6. The rigid hypothesis, accepted when it explains the pixels as well and
   the depths within 1.5x.

``run_condition`` returns the initial state, the first inner solve's and
the final state, the valid mask, the chosen weights and the rounds, and
counts the inner solves it made.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import geometry as G
from . import solver as S

RIGID_DEPTH_TAU = 1.5


class ConditionResult(NamedTuple):
    valid: np.ndarray
    initial: S.PairState
    first: S.PairState  # the first inner solve's result
    final: S.PairState
    weights: np.ndarray
    rounds: int
    rigid_accepted: bool
    inner_solves: int


class Observations(NamedTuple):
    kp1: np.ndarray
    kp2: np.ndarray
    d1: np.ndarray
    d2: np.ndarray
    T1w: tuple
    T2w: tuple


def observe(cfg: dict, c2_pose, orig, moved, noise_seed: int, device) -> Observations:
    """Steps 1-2 on ``device`` (float32), noise from numpy."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    rng = np.random.default_rng(noise_seed)
    c1, c2 = t(cfg["c1_pose"]), t(c2_pose)
    T1w = (torch.eye(3, dtype=torch.float32, device=device), c1)
    T2w = (G.look_at(c2, t(moved[0])), c2)
    cam = t(cfg["kb8"])
    p1c = G.apply(*T1w, t(orig))
    p2c = G.apply(*T2w, t(moved))
    kp1 = G.project(cam, p1c).cpu().numpy()
    kp2 = G.project(cam, p2c).cpu().numpy()
    sigma_px = max(cfg["pixel_noise_px"], 1e-300)
    kp1 = np.round(kp1 + rng.normal(scale=sigma_px, size=kp1.shape), cfg["pixel_decimals"])
    kp2 = np.round(kp2 + rng.normal(scale=sigma_px, size=kp2.shape), cfg["pixel_decimals"])
    sigma_d = max(cfg["depth_noise_mm"] / 1000.0, 1e-300)
    d1 = p1c.cpu().numpy()[:, 2] + rng.normal(scale=sigma_d, size=len(orig))
    d2 = p2c.cpu().numpy()[:, 2] + rng.normal(scale=sigma_d, size=len(orig))
    return Observations(kp1, kp2, d1, d2, T1w, T2w)


def triangulate(cfg: dict, obs: Observations, device):
    """Step 3: (p1, p2, valid)."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    cam = t(cfg["kb8"])
    xn1 = G.unproject(cam, t(obs.kp1))
    xn2 = G.unproject(cam, t(obs.kp2))
    xn1 = xn1 / torch.linalg.norm(xn1, dim=-1, keepdim=True)
    xn2 = xn2 / torch.linalg.norm(xn2, dim=-1, keepdim=True)
    xn1 = xn1 / xn1[:, 2:3] * t(obs.d1)[:, None]
    xn2 = xn2 / xn2[:, 2:3] * t(obs.d2)[:, None]
    p1, p2 = G.triangulate_depth_in_rays(xn1, xn2, obs.T1w, obs.T2w)
    valid = G.valid_parallax_mask(xn1, xn2, obs.T1w, obs.T2w, p1, p2, cfg["min_cos"])
    return p1, p2, valid.cpu().numpy()


def scale_prior(p, T, d, valid):
    """Step 4 for one camera: (mean(d / z), its standard error)."""
    z = G.apply(T[0], T[1], p).cpu().numpy()[:, 2]
    v = np.asarray(valid, dtype=bool) & (np.asarray(d) != 0)
    ratios = np.asarray(d)[v] / z[v]
    return float(ratios.mean()), float(ratios.std() / max(np.sqrt(len(ratios)), 1.0))


def first_problem(cfg: dict, c2_pose, orig, moved, noise_seed: int, device):
    """Steps 1-4 and the first round's pair data: (data, state, obs, valid)."""
    obs = observe(cfg, c2_pose, orig, moved, noise_seed, device)
    p1, p2, valid = triangulate(cfg, obs, device)
    s1, se1 = scale_prior(p1, obs.T1w, obs.d1, valid)
    s2, se2 = scale_prior(p2, obs.T2w, obs.d2, valid)
    priors = (s1, 1.0 / max(se1, 1e-6) ** 2, s2, 1.0 / max(se2, 1e-6) ** 2)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    state = S.PairState(p1=p1, p2=p2, s1=f(s1), s2=f(s2), Rg=torch.eye(3, dtype=torch.float32, device=device),
                        tg=torch.zeros(3, dtype=torch.float32, device=device))
    data = S.pair_data(obs.kp1, obs.kp2, obs.d1, obs.d2, valid, cfg["kb8"], obs.T1w, obs.T2w,
                       p1.cpu().numpy(), p2.cpu().numpy(), priors, device)
    return data, state, obs, valid, priors


def _update(valid, new, old) -> float:
    vm = np.asarray(valid, dtype=bool)
    d1 = np.linalg.norm((new.p1 - old.p1).cpu().numpy()[vm], axis=-1).sum()
    d2 = np.linalg.norm((new.p2 - old.p2).cpu().numpy()[vm], axis=-1).sum()
    return float(d1 + d2)


def _nm_round(data, state0, z0, zlb, zub, sigma_d, n_inner, nm_iters, xtol, probe, e_ref, solve):
    """One round's search over z = log10(arap weight) and the best weight's
    solve: (weight, state, objective)."""
    dtype, dev = state0.p1.dtype, state0.p1.device
    vm = data.valid.to(dtype)
    n_valid = torch.clamp(torch.sum(vm), min=1.0)
    d_scale = torch.clamp(torch.sum(vm * data.depth1) / n_valid, min=1e-2)
    e_ref = torch.clamp(torch.as_tensor(e_ref, dtype=dtype, device=dev), min=S.TINY)

    def run(z):
        hyper = S.Hyper(rep_w=torch.ones((), dtype=dtype, device=dev), arap_w=torch.pow(10.0, z[0]),
                        depth_sigma=sigma_d)
        return solve(data, hyper, state0, n_inner)

    def objective(z):
        res = run(z)
        s1, s2 = S.pixel_sigmas(data, res.state.p1, res.state.p2)
        disc = (torch.clamp(torch.log(torch.clamp(s1, min=S.TINY)), min=0.0) ** 2
                + torch.clamp(torch.log(torch.clamp(s2, min=S.TINY)), min=0.0) ** 2)
        tie = torch.sum(S.arap_energies(data, res.state)) / e_ref
        disp = torch.sum(vm * (torch.linalg.norm(res.state.p1 - state0.p1, dim=-1)
                               + torch.linalg.norm(res.state.p2 - state0.p2, dim=-1))) / n_valid
        f = torch.where(disc <= 0.0, 1e-3 * tie / (1.0 + tie) + 1e-6 * disp / (d_scale + disp),
                        (1e-3 + 1e-6) + disc)
        return torch.where(torch.isfinite(f), f, torch.full_like(f, math.inf)).to(dtype)

    batch = lambda zs: torch.stack([objective(z) for z in zs])
    if probe:
        frac = (np.arange(8)[:, None] + 0.5) / 8
        grid = torch.as_tensor(frac % 1.0, dtype=dtype, device=dev)
        probes = torch.cat([z0[None], zlb + grid * (zub - zlb)], dim=0)
        zc = probes[torch.argmin(batch(probes))]
    else:
        zc = z0
    simplex = torch.clamp(torch.cat([zc[None], zc[None] + ((zub - zlb) / 16.0)[None]], dim=0), zlb, zub)
    fvals = batch(simplex)
    inf = torch.full((), math.inf, dtype=dtype, device=dev)
    for _ in range(nm_iters):
        order = torch.argsort(fvals, stable=True)
        simplex, fvals = simplex[order], fvals[order]
        best, worst = simplex[0], simplex[1]
        fb, fsw, fw = fvals[0], fvals[0], fvals[1]
        xo = simplex[0]
        xr = torch.clamp(xo + (xo - worst), zlb, zub)
        xe = torch.clamp(xo + 2.0 * (xr - xo), zlb, zub)
        xoc = torch.clamp(xo + 0.5 * (xr - xo), zlb, zub)
        xic = torch.clamp(xo - 0.5 * (xo - worst), zlb, zub)
        fr = objective(xr)
        need_e = bool(fr < fb)
        try_oc = bool((fr >= fsw) & (fr < fw))
        try_ic = bool((fr >= fsw) & ~(fr < fw))
        fe = foc = fic = inf
        if need_e:
            fe = objective(xe)
        elif try_oc:
            foc = objective(xoc)
        elif try_ic:
            fic = objective(xic)
        accept_expand = need_e and bool(fe < fr)
        accept_reflect = bool((fb <= fr) & (fr < fsw)) or (need_e and not bool(fe < fr))
        accept_oc = try_oc and bool(foc <= fr)
        accept_ic = try_ic and bool(fic < fw)
        if (try_oc and not accept_oc) or (try_ic and not accept_ic):
            shrink = torch.clamp(best[None] + 0.5 * (simplex[1:] - best[None]), zlb, zub)
            simplex = torch.cat([best[None], shrink], dim=0)
            fvals = torch.cat([fvals[:1], batch(shrink)])
        else:
            if accept_expand:
                new_pt, new_f = xe, fe
            elif accept_reflect:
                new_pt, new_f = xr, fr
            elif accept_oc:
                new_pt, new_f = xoc, foc
            else:
                new_pt, new_f = xic, fic
            simplex = torch.cat([simplex[:1], new_pt[None]], dim=0)
            fvals = torch.cat([fvals[:1], new_f.reshape(1)])
        diam = torch.max(torch.abs(simplex - simplex[0:1]), dim=0).values
        if bool(torch.all((diam < xtol[1]) | (diam < xtol[0] * torch.abs(simplex[0])))):
            break
    ibest = torch.argmin(fvals)
    res = run(simplex[ibest])
    return float(torch.pow(10.0, simplex[ibest][0])), res.state, fvals[ibest]


def run_condition(cfg: dict, c2_pose, orig, moved, noise_seed: int, device) -> ConditionResult:
    """Steps 1-6 of one condition (see the module docstring). The search
    runs over the ARAP weight alone: the configuration fixes the
    reprojection and global weights at their bounds."""
    n_solves = [0]
    first = []

    def solve(data, hyper, state, n_it):
        n_solves[0] += 1
        res = S.solve_pair(data, hyper, state, n_it)
        first.append(res.state)
        return res

    data, state, obs, valid, priors = first_problem(cfg, c2_pose, orig, moved, noise_seed, device)
    initial = state
    f32 = dict(dtype=torch.float32, device=device)
    (rep_lb, rep_ub), (glob_lb, glob_ub), (arap_lb, arap_ub) = (cfg["weight_bounds"][k] for k in ("rep", "global", "arap"))
    if rep_lb != rep_ub or glob_lb != glob_ub or not (arap_lb > 0 and arap_ub / arap_lb > 1e2):
        raise ValueError("the reference searches log10 of the ARAP weight alone")
    weights = np.array(cfg["start_weights"], dtype=np.float64)
    sigma_d = torch.tensor(cfg["depth_sigma_mm"] / 1000.0, **f32)
    n_inner = cfg["lm_iterations"]
    nm_iters = max(1, (cfg["nm_evaluations"] - 2) * 2 // 3)
    n_points = 2 * int(valid.sum())
    update, rounds, f_prev, e_ref = 100.0, 0, None, None
    for i in range(1, cfg["rounds"] + 1):
        if update < 1e-4 * n_points:
            break
        rounds = i
        if i > 1:
            data = S.pair_data(obs.kp1, obs.kp2, obs.d1, obs.d2, valid, cfg["kb8"], obs.T1w, obs.T2w,
                               state.p1.cpu().numpy(), state.p2.cpu().numpy(), priors, device)
        if e_ref is None:
            e_ref = float(torch.sum(S.arap_energies(data, state)))
        w_best, new_state, f_best = _nm_round(
            data, state, torch.tensor([np.log10(max(weights[2], 1e-300))], **f32),
            torch.tensor([np.log10(arap_lb)], **f32), torch.tensor([np.log10(arap_ub)], **f32),
            sigma_d, n_inner, nm_iters, (cfg["nlopt_xtol_rel"], cfg["nlopt_xtol_abs"]), i == 1, e_ref, solve)
        f_best = float(f_best)
        if f_prev is not None and not (f_best < f_prev - 1e-6):
            break
        f_prev = f_best
        weights = np.array([rep_lb, glob_lb, w_best], dtype=np.float64)
        update = _update(valid, new_state, state)
        state = new_state

    rigid_accepted = False
    if cfg["rigid_selection"] and rounds > 0:
        hyper = S.Hyper(rep_w=torch.tensor(weights[0], **f32), arap_w=torch.tensor(weights[2], **f32),
                        depth_sigma=sigma_d)
        count = lambda res: n_solves.__setitem__(0, n_solves[0] + 1)
        cand, diag = S.solve_rigid(data, hyper, state, max(30, n_inner), count)
        s1g, s2g = S.pixel_sigmas(data, state.p1, state.p2)
        dg1, dg2 = S.depth_discrepancy(data, state.p1, state.p2, state.s1, state.s2)
        one_sided = lambda a, b: (max(np.log(max(float(a), 1e-300)), 0.0) ** 2
                                  + max(np.log(max(float(b), 1e-300)), 0.0) ** 2)
        f_rigid, f_general = one_sided(diag[0], diag[1]), one_sided(s1g, s2g)
        if (np.isfinite(f_rigid) and f_rigid <= f_general + 1e-9
                and max(float(diag[2]), float(diag[3])) <= RIGID_DEPTH_TAU * max(float(dg1), float(dg2), float(sigma_d))):
            state = cand
            rigid_accepted = True
    return ConditionResult(valid=valid, initial=initial, first=first[0], final=state, weights=weights, rounds=rounds,
                           rigid_accepted=rigid_accepted, inner_solves=n_solves[0])
