"""Rigid-hypothesis refinement: model selection against the general solve.

Counterpart of ``triangulation_in_deformable_scenes_tpu/models/rigid.py:62-395``
(see that module's docstring for the model and the acceptance rule): the
scene-is-rigid hypothesis, state (p1[N,3], s1, s2, Rr, tr) with
p2 := Rr p1 + tr, is solved by the same dense LM (``ops/lm.py``, one damped
solve per trial, dim 3N+8) from two inits per restart round.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from .. import tracing
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import lm as lm_ops
from ..precision import TINY
from . import deformable


class RigidState(NamedTuple):
    p1: torch.Tensor  # [N, 3]
    s1: torch.Tensor
    s2: torch.Tensor
    Rr: torch.Tensor  # [3, 3] scene motion: p2 = Rr p1 + tr
    tr: torch.Tensor  # [3]


def _rigid_tangent_dim(n: int) -> int:
    return 3 * n + 8


def apply_delta_rigid(state: RigidState, delta: torch.Tensor) -> RigidState:
    n = state.p1.shape[0]
    dR, dt = lie.se3_exp(delta[3 * n + 2 : 3 * n + 8])
    Rr, tr = lie.compose(dR, dt, state.Rr, state.tr)
    return RigidState(
        p1=state.p1 + delta[: 3 * n].reshape(n, 3),
        s1=state.s1 + delta[3 * n],
        s2=state.s2 + delta[3 * n + 1],
        Rr=Rr,
        tr=tr,
    )


def _p2_of(state: RigidState) -> torch.Tensor:
    return state.p1 @ state.Rr.T + state.tr


def residual_vector_rigid(cam_kind, data, hyper, state: RigidState, spec=deformable.ModelSpec()):
    """Weighted residual vector, sum(r^2) == robust chi2 (``rigid.py:88-146``)."""
    vm = data.valid.to(state.p1.dtype)
    p2 = _p2_of(state)

    def rep_block(p, R, t, kp, inv_s2):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        chi2 = torch.sum(e * e, dim=-1).detach() * inv_s2 * hyper.rep_w
        _, drho = deformable._huber_rho(chi2)
        w = torch.sqrt(drho * inv_s2 * hyper.rep_w) * vm
        return (w[:, None] * e).reshape(-1)

    r_rep1 = rep_block(state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1)
    r_rep2 = rep_block(p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2)

    inv_sigma_d = 1.0 / hyper.depth_sigma
    rd1 = vm * inv_sigma_d * deformable._depth_errors(
        data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth
    )
    rd2 = vm * inv_sigma_d * deformable._depth_errors(
        data, p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth
    )
    r_sprior = torch.stack(
        [
            torch.sqrt(data.s1_info) * (state.s1 - data.s1_prior),
            torch.sqrt(data.s2_info) * (state.s2 - data.s2_prior),
        ]
    )
    return torch.cat([r_rep1, r_rep2, rd1, rd2, r_sprior])


def robust_cost_rigid(cam_kind, data, hyper, state, spec=deformable.ModelSpec()):
    """Robustified chi2 of the rigid model (``rigid.py:149-182``)."""
    with tracing.span("cost"):
        vm = data.valid.to(state.p1.dtype)
        p2 = _p2_of(state)

        def rep_cost(p, R, t, kp, inv_s2):
            e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
            chi2 = torch.sum(e * e, dim=-1) * inv_s2 * hyper.rep_w
            rho, _ = deformable._huber_rho(chi2)
            return torch.sum(vm * rho)

        cost = rep_cost(state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1)
        cost = cost + rep_cost(p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2)

        info_d = 1.0 / (hyper.depth_sigma * hyper.depth_sigma)
        ed1 = deformable._depth_errors(data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth)
        ed2 = deformable._depth_errors(data, p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth)
        cost = cost + torch.sum(vm * info_d * (ed1 * ed1 + ed2 * ed2))

        cost = cost + data.s1_info * (state.s1 - data.s1_prior) ** 2
        cost = cost + data.s2_info * (state.s2 - data.s2_prior) ** 2
        return cost


def build_system_rigid(cam_kind, data, hyper, state, spec=deformable.ModelSpec()):
    """Dense Gauss-Newton normal equations [3N+8]^2 via jacfwd
    (``rigid.py:185-197``)."""
    with tracing.span("assembly"):
        dim = _rigid_tangent_dim(state.p1.shape[0])

        def f(delta):
            r = residual_vector_rigid(cam_kind, data, hyper, apply_delta_rigid(state, delta), spec)
            return r, r

        zero = torch.zeros((dim,), dtype=state.p1.dtype, device=state.p1.device)
        J, r = jacfwd(f, has_aux=True)(zero)
        return J.T @ J, J.T @ r


class RigidDiagnostics(NamedTuple):
    sigma1: torch.Tensor
    sigma2: torch.Tensor
    depth_rms1: torch.Tensor
    depth_rms2: torch.Tensor
    rigid_fit_rms: torch.Tensor


def _pixel_sigmas(cam_kind, data, p1, p2):
    vm = data.valid.to(p1.dtype)
    n = torch.clamp(torch.sum(vm), min=1.0)

    def desv(p, R, t, kp):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        rms = torch.sqrt(torch.sum(vm[:, None] * e * e, dim=0) / n)
        return torch.mean(rms)

    return desv(p1, data.R1w, data.t1w, data.kp1), desv(p2, data.R2w, data.t2w, data.kp2)


def depth_discrepancy(data, p1, p2, s1, s2):
    """Physical depth residual rms per camera, rms(d/s - z) (``rigid.py:223-239``)."""
    vm = data.valid.to(p1.dtype)
    n = torch.clamp(torch.sum(vm), min=1.0)

    def rms(p, s, R, t, d):
        z = lie.apply(R, t, p)[..., 2]
        e = d / torch.clamp(s, min=TINY) - z
        return torch.sqrt(torch.sum(vm * e * e) / n)

    return (
        rms(p1, s1, data.R1w, data.t1w, data.depth1),
        rms(p2, s2, data.R2w, data.t2w, data.depth2),
    )


def _midpoint_p1(cam_kind, data, Rr, tr, p1_fallback):
    """Closed-form two-view triangulation of p1 given the scene motion
    (``rigid.py:242-276``)."""
    dtype = p1_fallback.dtype

    def ray(R, t, kp):
        xn = cam_ops.unproject(cam_kind, data.cam_params, kp)
        d = xn / torch.linalg.norm(xn, dim=-1, keepdim=True)
        return -R.T @ t, d @ R

    c1, d1 = ray(data.R1w, data.t1w, data.kp1)
    c2, d2 = ray(data.R2w @ Rr, data.R2w @ tr + data.t2w, data.kp2)

    eye = torch.eye(3, dtype=dtype, device=p1_fallback.device)
    A1 = eye[None] - d1[:, :, None] * d1[:, None, :]
    A2 = eye[None] - d2[:, :, None] * d2[:, None, :]
    A = A1 + A2
    b = A1 @ c1 + A2 @ c2
    ok = torch.sum(d1 * d2, dim=-1) < 0.9999
    p = torch.linalg.solve(A + 1e-6 * eye[None], b[..., None]).squeeze(-1)
    finite = torch.all(torch.isfinite(p), dim=-1)
    use = (ok & finite & data.valid)[:, None]
    return torch.where(use, p, p1_fallback)


def _solve_core(cam_kind, data, hyper, rstate0, n_iterations, spec, stats=None):
    res = lm_ops.lm_optimize(
        build_system=lambda s: build_system_rigid(cam_kind, data, hyper, s, spec),
        robust_cost=lambda s: robust_cost_rigid(cam_kind, data, hyper, s, spec),
        apply_delta=apply_delta_rigid,
        state0=rstate0,
        n_iterations=n_iterations,
    )
    if stats is not None:
        stats.add(res, rigid=True)
    return res.state, res.cost


def _one_rigid_round(cam_kind, data, hyper, state, n_iterations, spec, stats=None):
    """One restart round (``rigid.py:291-344``)."""
    vm = data.valid.to(state.p1.dtype)
    R, _ = lie.kabsch(state.p1, state.p2, weights=vm)
    wsum = torch.clamp(torch.sum(vm), min=1.0)
    c1 = torch.sum(vm[:, None] * state.p1, dim=0) / wsum
    c2 = torch.sum(vm[:, None] * state.p2, dim=0) / wsum
    tr = c2 - R @ c1
    fit = state.p1 @ R.T + tr - state.p2
    fit_rms = torch.sqrt(torch.sum(vm * torch.sum(fit * fit, dim=-1)) / wsum)

    def scale_anchor(p, Rw, t, d):
        z = lie.apply(Rw, t, p)[..., 2]
        ratio = d / torch.clamp(z, min=TINY)
        m = torch.sum(vm * ratio) / wsum
        var = torch.sum(vm * (ratio - m) ** 2) / wsum
        se = torch.sqrt(torch.clamp(var / wsum, min=1e-12))
        return m, 1.0 / (se * se)

    s1p, s1i = scale_anchor(state.p1, data.R1w, data.t1w, data.depth1)
    s2p, s2i = scale_anchor(state.p2, data.R2w, data.t2w, data.depth2)
    data = data._replace(s1_prior=s1p, s1_info=s1i, s2_prior=s2p, s2_info=s2i)

    inits = [
        RigidState(p1=state.p1, s1=s1p, s2=s2p, Rr=R, tr=tr),
        RigidState(p1=_midpoint_p1(cam_kind, data, R, tr, state.p1), s1=s1p, s2=s2p, Rr=R, tr=tr),
    ]
    best, best_cost = None, None
    for r0 in inits:
        rs, cost = _solve_core(cam_kind, data, hyper, r0, n_iterations, spec, stats)
        if best is None or tracing.read(cost < best_cost, bool):
            best, best_cost = rs, cost

    rs = best
    p2 = _p2_of(rs)
    Rg = rs.Rr.T
    cand = deformable.PairState(p1=rs.p1, p2=p2, s1=rs.s1, s2=rs.s2, Rg=Rg, tg=Rg @ rs.tr)
    s1px, s2px = _pixel_sigmas(cam_kind, data, rs.p1, p2)
    dr1, dr2 = depth_discrepancy(data, rs.p1, p2, rs.s1, rs.s2)
    return cand, RigidDiagnostics(
        sigma1=s1px, sigma2=s2px, depth_rms1=dr1, depth_rms2=dr2, rigid_fit_rms=fit_rms
    )


def solve_rigid(cam_kind, data, hyper, state0, n_iterations, spec=deformable.ModelSpec(),
                max_restarts: int = 5, stats=None):
    """Restarted multi-start rigid LM (``rigid.py:347-395``); returns
    (PairState candidate, diagnostics)."""
    with tracing.span("rigid.select"):
        sigma_d = torch.clamp(hyper.depth_sigma, min=TINY)

        def score(diag: RigidDiagnostics) -> float:
            return tracing.read(
                diag.sigma1**2 + diag.sigma2**2
                + (diag.depth_rms1**2 + diag.depth_rms2**2) / (sigma_d * sigma_d),
                float,
            )

        cur = state0
        best = None
        best_score = np.inf
        for _ in range(max_restarts):
            cand, diag = _one_rigid_round(cam_kind, data, hyper, cur, n_iterations, spec, stats)
            s = score(diag)
            if not np.isfinite(s) or s >= best_score - 1e-9:
                break
            best, best_score = (cand, diag), s
            cur = cand
        if best is None:
            best = (cand, diag)
        return best
