"""Outer refinement loop: repeated inner solves + derivative-free weight search.

Counterpart of ``triangulation_in_deformable_scenes_tpu/models/outer.py``
(the reference's ``deformationOptimization``); see that module's docstring
for the documented deviations from the reference this port keeps: the log10
Nelder-Mead weight search with a round-1 probe, the monotone outer
acceptance, the one-sided lexicographic discrepancy objective, and the
rigid-hypothesis model selection.

The JAX package runs one round's search as a single jitted program
(``nm_weight_search_device``, ``outer.py:235-478``); here it is a host loop
(``nm_weight_search``) with the same lazy decision tree. The simplex and the
objective values stay on the device in f32; each decision reads its
comparisons back to the host.

The two other selections are ported as in JAX: ``open3DArap`` deforms the
first keyframe's mesh with ``ops/arap.arap_deform`` (only vertex 0 pinned,
to the first moved point: the reference's zero-initialised constraint
list), and the ``eigen`` weights selection runs ``_numdiff_lm``, a host
numpy LM over the weights whose every residual evaluation is an inner
solve followed by the pixel deviations of ``utils/metrics``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import arap as arap_ops
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import mesh as mesh_ops
from ..utils import metrics as metrics_mod
from ..precision import FP, TINY
from . import deformable


class OuterConfig(NamedTuple):
    rep_w: float
    global_w: float
    arap_w: float
    alpha: float
    beta: float
    depth_sigma: float
    n_optimizations: int
    n_opt_iterations: int
    opt_selection: str
    weights_selection: str
    nlopt_max_eval: int
    nlopt_rel_tol: float
    nlopt_abs_tol: float
    lower_bounds: tuple  # (rep, global, arap)
    upper_bounds: tuple
    model: str = "ARAP"
    rigid_select: bool = True


def outer_config(cfg) -> OuterConfig:
    """The outer loop's settings from a pipeline ``Config``, as both
    pipelines build them (``simulation.py:209-227``, ``sequence.py:421-439``;
    the depth weight falls back to the simulated depth error when unset)."""
    depth_w = cfg.sim_depth_weight if cfg.sim_depth_weight > 0 else cfg.sim_depth_error
    return OuterConfig(
        rep_w=cfg.opt_rep_weight,
        global_w=cfg.opt_global_weight,
        arap_w=cfg.opt_arap_weight,
        alpha=cfg.opt_alpha_weight,
        beta=cfg.opt_beta_weight,
        depth_sigma=depth_w / 1000.0,
        n_optimizations=cfg.n_optimizations,
        n_opt_iterations=cfg.n_opt_iterations,
        opt_selection=cfg.opt_selection,
        weights_selection=cfg.opt_weights_selection,
        nlopt_max_eval=cfg.nlopt_n_optimizations,
        nlopt_rel_tol=cfg.nlopt_rel_tolerance,
        nlopt_abs_tol=cfg.nlopt_abs_tolerance,
        lower_bounds=(cfg.nlopt_rep_lower, cfg.nlopt_global_lower, cfg.nlopt_arap_lower),
        upper_bounds=(cfg.nlopt_rep_upper, cfg.nlopt_global_upper, cfg.nlopt_arap_upper),
        model=cfg.opt_model,
    )


@dataclasses.dataclass
class SolveStats:
    """Work counters of one outer run: inner solves (``solve_pair`` and
    rigid LM calls), LM iterations that accepted a step, and damped solves
    (LM trials), of which ``rigid_solves`` were the rigid model's."""

    inner_solves: int = 0
    lm_iterations: int = 0
    lm_solves: int = 0
    rigid_solves: int = 0

    def add(self, res, rigid: bool = False) -> None:
        self.inner_solves += 1
        self.lm_iterations += int(res.n_accepted)
        self.lm_solves += int(res.n_solves)
        if rigid:
            self.rigid_solves += int(res.n_solves)


@dataclasses.dataclass
class OuterResult:
    state: deformable.PairState
    weights: np.ndarray  # final (rep, global, arap)
    rounds: int
    last_update: float
    rigid_accepted: bool = False
    stats: SolveStats = dataclasses.field(default_factory=SolveStats)


# Rigid-hypothesis acceptance factor on the physical depth discrepancy
# (``outer.py:118-124``).
RIGID_DEPTH_TAU = 1.5


def _scalar(x, like):
    return torch.tensor(float(x), dtype=FP, device=like.device)


def _hyper(weights, cfg: OuterConfig, like) -> deformable.Hyper:
    """``outer.py:127-138``; tensors on ``like``'s device."""
    sigma = deformable.model_depth_sigma(cfg.model)
    if sigma is None:
        sigma = float(cfg.depth_sigma)
    return deformable.Hyper(
        rep_w=_scalar(weights[0], like),
        arap_w=_scalar(weights[2], like),
        depth_sigma=_scalar(sigma, like),
        global_w=_scalar(weights[1], like),
        alpha=_scalar(cfg.alpha, like),
        beta=_scalar(cfg.beta, like),
    )


def _update_magnitude(valid, new_state, state) -> float:
    """Summed point displacement over both sets (``outer.py:161-164``)."""
    vm = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid, dtype=bool)
    d1 = np.linalg.norm((new_state.p1 - state.p1).cpu().numpy()[vm], axis=-1).sum()
    d2 = np.linalg.norm((new_state.p2 - state.p2).cpu().numpy()[vm], axis=-1).sum()
    return float(d1 + d2)


def arap_optimization(cam_kind, data, state, weights, cfg: OuterConfig, stats: Optional[SolveStats] = None):
    """One inner solve; returns (new_state, update_magnitude) (``outer.py:141-164``)."""
    if cfg.model not in deformable.MODELS:
        raise ValueError(f"Unknown deformation model '{cfg.model}'; known: {sorted(deformable.MODELS)}")
    spec = deformable.MODELS[cfg.model]
    res = deformable.solve_pair(
        cam_kind, data, _hyper(weights, cfg, state.p1), state, cfg.n_opt_iterations, spec
    )
    if stats is not None:
        stats.add(res)
    return res.state, _update_magnitude(data.valid, res.state, state)


def _numdiff_lm(residuals, x0, lb, ub, max_evals=10, eps_rel=1e-3, lam0=1e-3):
    """Tiny Levenberg-Marquardt with a forward-difference Jacobian over a
    low-dimensional weight vector (the reference's Eigen
    ``NumericalDiff<EigenOptimizationFunctor>`` path; the port's own copy of
    ``outer.py:167-211``, numpy). Frozen dimensions (lb == ub) are skipped."""
    x = np.clip(np.asarray(x0, dtype=np.float64), lb, ub)
    free = np.nonzero(ub > lb)[0]
    n_eval = 0
    r = residuals(x)
    n_eval += 1
    lam = lam0
    while n_eval < max_evals and len(free):
        J = np.zeros((len(r), len(free)))
        for c, i in enumerate(free):
            h = max(abs(x[i]) * eps_rel, 1e-9)
            xp = x.copy()
            xp[i] = min(x[i] + h, ub[i])
            rp = residuals(xp)
            n_eval += 1
            J[:, c] = (rp - r) / max(xp[i] - x[i], 1e-12)
            if n_eval >= max_evals:
                break
        A = J.T @ J + lam * np.eye(len(free))
        g = J.T @ r
        try:
            delta = np.linalg.solve(A, -g)
        except np.linalg.LinAlgError:
            break
        x_new = x.copy()
        x_new[free] = np.clip(x[free] + delta, lb[free], ub[free])
        if n_eval >= max_evals:
            break
        r_new = residuals(x_new)
        n_eval += 1
        if r_new @ r_new < r @ r:
            x, r = x_new, r_new
            lam = max(lam / 3.0, 1e-12)
        else:
            lam *= 10.0
    return x


def _pixel_sigma_device(cam_kind, data: deformable.PairData, state: deformable.PairState):
    """Per-camera "standard desv" on the device (``outer.py:214-228``)."""
    vm = data.valid.to(state.p1.dtype)
    n = torch.clamp(torch.sum(vm), min=1.0)

    def desv(p, R, t, kp):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        rms = torch.sqrt(torch.sum(vm[:, None] * e * e, dim=0) / n)
        return torch.mean(rms)

    return (
        desv(state.p1, data.R1w, data.t1w, data.kp1),
        desv(state.p2, data.R2w, data.t2w, data.kp2),
    )


def nm_weight_search(
    cam_kind: str,
    data: deformable.PairData,
    state0: deformable.PairState,
    z_template,
    free_idx,
    zlb,
    zub,
    wide,
    sigma_d,
    alpha,
    beta,
    *,
    n_inner: int,
    spec: deformable.ModelSpec,
    nm_iters: int,
    xtol_rel: float,
    xtol_abs: float,
    probe: bool = True,
    e_ref=None,
    stats: Optional[SolveStats] = None,
):
    """One outer round's lazy Nelder-Mead weight search + final solve
    (``outer.py:235-478``), as a host loop over device-resident f32 values.

    ``z_template``/``zlb``/``zub`` [3] f32, ``free_idx`` [m] int64 and
    ``wide`` [3] bool are tensors on the data's device. Returns
    (best_weights [3], final PairState, best objective).
    """
    dtype = state0.p1.dtype
    dev = state0.p1.device
    m = int(free_idx.shape[0])
    z0 = z_template[free_idx]
    zlb_f = zlb[free_idx]
    zub_f = zub[free_idx]

    def from_search(zf):
        z = z_template.index_put((free_idx,), zf)
        return torch.where(wide, torch.pow(10.0, z), z)

    vm = data.valid.to(dtype)
    n_valid = torch.clamp(torch.sum(vm), min=1.0)
    d_scale = torch.clamp(torch.sum(vm * data.depth1) / n_valid, min=1e-2)

    one = torch.ones((), dtype=dtype, device=dev)
    unit_hyper = deformable.Hyper(
        rep_w=one, arap_w=one, depth_sigma=sigma_d, global_w=one, alpha=alpha, beta=beta,
    )
    if e_ref is None:
        e_ref = torch.sum(deformable._arap_energies(data, state0, spec, unit_hyper))
    e_ref = torch.clamp(torch.as_tensor(e_ref, dtype=dtype, device=dev), min=TINY)

    def solve(zf):
        w = from_search(zf)
        hyper = deformable.Hyper(
            rep_w=w[0], arap_w=w[2], depth_sigma=sigma_d, global_w=w[1], alpha=alpha, beta=beta,
        )
        res = deformable.solve_pair(cam_kind, data, hyper, state0, n_inner, spec)
        if stats is not None:
            stats.add(res)
        return w, res

    def objective(zf):
        _, res = solve(zf)
        s1, s2 = _pixel_sigma_device(cam_kind, data, res.state)
        disc = (
            torch.clamp(torch.log(torch.clamp(s1, min=TINY)), min=0.0) ** 2
            + torch.clamp(torch.log(torch.clamp(s2, min=TINY)), min=0.0) ** 2
        )
        e_res = torch.sum(deformable._arap_energies(data, res.state, spec, unit_hyper))
        tie = e_res / e_ref
        disp = torch.sum(
            vm * (torch.linalg.norm(res.state.p1 - state0.p1, dim=-1)
                  + torch.linalg.norm(res.state.p2 - state0.p2, dim=-1))
        ) / n_valid
        f_feas = 1e-3 * tie / (1.0 + tie) + 1e-6 * disp / (d_scale + disp)
        f = torch.where(disc <= 0.0, f_feas, (1e-3 + 1e-6) + disc)
        return torch.where(torch.isfinite(f), f, torch.full_like(f, math.inf)).to(dtype)

    def objective_batch(zs):
        return torch.stack([objective(z) for z in zs])

    bounded = zub_f - zlb_f < 1e30
    if probe:
        P = 8
        frac = (np.arange(P)[:, None] + 0.5) / P
        offs = np.array([(0.381966011 * k) % 1.0 for k in range(m)])[None, :]
        grid01 = torch.as_tensor((frac + offs) % 1.0, dtype=dtype, device=dev)
        probes = torch.where(bounded, zlb_f + grid01 * (zub_f - zlb_f), z0)
        probes = torch.cat([z0[None].to(dtype), probes], dim=0)
        fprobe = objective_batch(probes)
        zc = probes[torch.argmin(fprobe)]
    else:
        zc = z0.to(dtype)

    steps = torch.where(bounded, (zub_f - zlb_f) / 16.0, torch.clamp(torch.abs(zc) * 0.25, min=0.25))
    simplex = torch.clamp(
        torch.cat([zc[None], zc[None] + torch.diag(steps)], dim=0), zlb_f, zub_f
    ).to(dtype)
    fvals = objective_batch(simplex)

    A_R, G_E, R_C, S_S = 1.0, 2.0, 0.5, 0.5
    inf = torch.full((), math.inf, dtype=dtype, device=dev)
    for _ in range(nm_iters):
        order = torch.argsort(fvals, stable=True)
        simplex = simplex[order]
        fvals = fvals[order]
        best, worst = simplex[0], simplex[m]
        fb, fsw, fw = fvals[0], fvals[m - 1], fvals[m]
        xo = torch.mean(simplex[:m], dim=0)
        xr = torch.clamp(xo + A_R * (xo - worst), zlb_f, zub_f)
        xe = torch.clamp(xo + G_E * (xr - xo), zlb_f, zub_f)
        xoc = torch.clamp(xo + R_C * (xr - xo), zlb_f, zub_f)
        xic = torch.clamp(xo - R_C * (xo - worst), zlb_f, zub_f)
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
        do_shrink = (try_oc and not accept_oc) or (try_ic and not accept_ic)

        if do_shrink:
            shrink = torch.clamp(best[None] + S_S * (simplex[1:] - best[None]), zlb_f, zub_f)
            simplex = torch.cat([best[None], shrink], dim=0)
            fvals = torch.cat([fvals[:1], objective_batch(shrink)])
        else:
            if accept_expand:
                new_pt, new_f = xe, fe
            elif accept_reflect:
                new_pt, new_f = xr, fr
            elif accept_oc:
                new_pt, new_f = xoc, foc
            else:
                new_pt, new_f = xic, fic
            simplex = torch.cat([simplex[:m], new_pt[None]], dim=0)
            fvals = torch.cat([fvals[:m], new_f.reshape(1)])

        # NLopt xtol semantics, per coordinate (``outer.py:454-459``).
        diam = torch.max(torch.abs(simplex - simplex[0:1]), dim=0).values
        xref = torch.abs(simplex[0])
        if bool(torch.all((diam < xtol_abs) | (diam < xtol_rel * xref))):
            break

    ibest = torch.argmin(fvals)
    wbest, res = solve(simplex[ibest])
    return wbest, res.state, fvals[ibest]


def deformation_optimization(
    cam_kind: str,
    cam_params,
    T1w,
    T2w,
    kp1,
    kp2,
    d1,
    d2,
    valid,
    state: deformable.PairState,
    cfg: OuterConfig,
    on_round: Optional[Callable] = None,
    mesh_backend: str = "auto",
    scale_priors=None,
) -> OuterResult:
    """Full outer loop (``outer.py:481-714``) on the device of ``state``.
    ``on_round(i, state, weights)`` fires after each non-final round."""
    dev = state.p1.device
    stats = SolveStats()
    n_points = 2 * int(np.asarray(valid).sum())
    weights = np.array([cfg.rep_w, cfg.global_w, cfg.arap_w], dtype=np.float64)
    lb = np.asarray(cfg.lower_bounds, dtype=np.float64)
    ub = np.asarray(cfg.upper_bounds, dtype=np.float64)

    update = 100.0
    rounds = 0
    f_prev = None
    e_ref = None
    data = None
    for i in range(1, cfg.n_optimizations + 1):
        if update < 1e-4 * n_points:
            break
        rounds = i

        if cfg.opt_selection == "open3DArap":
            # ``arapOpen3DOptimization`` (``outer.py:515-543``): deform the
            # first keyframe's mesh as rigidly as possible and take it as the
            # second point set; only vertex 0 is pinned, to the first moved
            # point, as the reference's zero-initialised constraint list does.
            vidx = torch.as_tensor(np.nonzero(np.asarray(valid, dtype=bool))[0], device=dev)
            p1v = state.p1[vidx]
            ctx = mesh_ops.build_mesh_context(p1v.cpu().numpy(), backend=mesh_backend)
            deformed = arap_ops.arap_deform(
                p_rest=p1v,
                nbr=torch.as_tensor(ctx.nbr, dtype=torch.int64, device=dev),
                nbr_mask=torch.as_tensor(ctx.nbr_mask, device=dev),
                weights=torch.as_tensor(ctx.weights, dtype=FP, device=dev),
                constraint_idx=torch.zeros(1, dtype=torch.int64, device=dev),
                constraint_pos=state.p2[vidx[:1]],
                iters=cfg.n_opt_iterations,
            )
            new_p2 = state.p2.clone()
            new_p2[vidx] = deformed
            update = float(torch.linalg.norm(new_p2[vidx] - state.p2[vidx], dim=-1).sum())
            state = state._replace(p2=new_p2)
            if on_round is not None and i != cfg.n_optimizations:
                on_round(i, state, weights)
            continue

        data = deformable.make_pair_data(
            kp1=kp1, kp2=kp2, depth1=d1, depth2=d2, valid=valid, cam_params=cam_params,
            T1w=T1w, T2w=T2w, p1=state.p1.cpu().numpy(), p2=state.p2.cpu().numpy(),
            mesh_backend=mesh_backend, scale_priors=scale_priors, device=dev,
        )

        if cfg.opt_selection == "twoOptimizations" and cfg.weights_selection == "eigen":
            # ``EigenOptimization.h:30-63`` (``outer.py:562-578``): LM over the
            # weights with residuals (log sigma_c1)^2 and (log sigma_c2)^2.
            def residuals(x):
                cand_state, _ = arap_optimization(cam_kind, data, state, x, cfg, stats)
                pix = metrics_mod.pixels_stand_dev(
                    cam_kind, cam_params, T1w, T2w, cand_state.p1, cand_state.p2, kp1, kp2, valid, device=dev
                )
                return np.array([np.log(max(pix.desvc1, 1e-300)) ** 2, np.log(max(pix.desvc2, 1e-300)) ** 2])

            weights = _numdiff_lm(residuals, weights, lb, ub, max_evals=10)
            state, update = arap_optimization(cam_kind, data, state, weights, cfg, stats)
        elif cfg.opt_selection == "twoOptimizations":
            wide = (lb > 0) & (ub / np.maximum(lb, 1e-300) > 1e2)

            def to_search(x):
                return np.where(wide, np.log10(np.maximum(x, 1e-300)), x)

            free_idx = np.nonzero(ub > lb)[0]
            if len(free_idx) == 0:
                state, update = arap_optimization(cam_kind, data, state, weights, cfg, stats)
            else:
                spec = deformable.MODELS[cfg.model]
                sigma_d = deformable.model_depth_sigma(cfg.model)
                if sigma_d is None:
                    sigma_d = float(cfg.depth_sigma)
                if e_ref is None:
                    # Round-1 snapshot energy: the fixed tie-break normalizer.
                    e_ref = float(torch.sum(deformable._arap_energies(
                        data, state, spec, _hyper((1.0, 1.0, 1.0), cfg, state.p1)
                    )))
                nm_iters = max(1, (int(cfg.nlopt_max_eval) - (len(free_idx) + 1)) * 2 // 3)
                f32 = dict(dtype=FP, device=dev)
                w_best, new_state, f_best = nm_weight_search(
                    cam_kind,
                    data,
                    state,
                    torch.as_tensor(to_search(weights), **f32),
                    torch.as_tensor(free_idx, dtype=torch.int64, device=dev),
                    torch.as_tensor(to_search(lb), **f32),
                    torch.as_tensor(to_search(ub), **f32),
                    torch.as_tensor(wide, device=dev),
                    _scalar(sigma_d, state.p1),
                    _scalar(cfg.alpha, state.p1),
                    _scalar(cfg.beta, state.p1),
                    n_inner=int(cfg.n_opt_iterations),
                    spec=spec,
                    nm_iters=nm_iters,
                    xtol_rel=float(cfg.nlopt_rel_tol),
                    xtol_abs=float(cfg.nlopt_abs_tol),
                    probe=(i == 1),
                    e_ref=e_ref,
                    stats=stats,
                )
                f_best = float(f_best)
                if f_prev is not None and not (f_best < f_prev - 1e-6):
                    # Monotone outer acceptance (``outer.py:638-647``).
                    break
                f_prev = f_best
                weights = w_best.cpu().numpy().astype(np.float64)
                update = _update_magnitude(data.valid, new_state, state)
                state = new_state
        else:
            state, update = arap_optimization(cam_kind, data, state, weights, cfg, stats)

        if on_round is not None and i != cfg.n_optimizations:
            on_round(i, state, weights)

    # Rigid-hypothesis model selection (``outer.py:660-709``).
    rigid_accepted = False
    spec = deformable.MODELS.get(cfg.model, deformable.ModelSpec())
    if cfg.rigid_select and rounds > 0 and data is not None and not spec.one_set:
        from . import rigid as rigid_mod

        sigma_d = deformable.model_depth_sigma(cfg.model)
        if sigma_d is None:
            sigma_d = float(cfg.depth_sigma)
        cand, diag = rigid_mod.solve_rigid(
            cam_kind, data, _hyper(weights, cfg, state.p1), state,
            max(30, int(cfg.n_opt_iterations)), spec, stats=stats,
        )
        s1g, s2g = rigid_mod._pixel_sigmas(cam_kind, data, state.p1, state.p2)
        dg1, dg2 = rigid_mod.depth_discrepancy(data, state.p1, state.p2, state.s1, state.s2)

        def one_sided(s1, s2):
            return (
                max(np.log(max(float(s1), 1e-300)), 0.0) ** 2
                + max(np.log(max(float(s2), 1e-300)), 0.0) ** 2
            )

        f_rigid = one_sided(diag.sigma1, diag.sigma2)
        f_general = one_sided(s1g, s2g)
        depth_rigid = max(float(diag.depth_rms1), float(diag.depth_rms2))
        depth_general = max(float(dg1), float(dg2))
        if (
            np.isfinite(f_rigid)
            and f_rigid <= f_general + 1e-9
            and depth_rigid <= RIGID_DEPTH_TAU * max(depth_general, sigma_d)
        ):
            state = cand
            rigid_accepted = True

    return OuterResult(
        state=state, weights=weights, rounds=rounds, last_update=update,
        rigid_accepted=rigid_accepted, stats=stats,
    )
