"""The inner solve of the plain reference: the deformable pair model, its
Gauss-Newton systems, Levenberg-Marquardt, and the rigid hypothesis.

State of one keyframe pair: p1, p2 [N, 3] (each point at keyframe 1 and at
keyframe 2), the depth scales s1, s2 and a global SE(3) (Rg, tg). Edges:
Huber-robust reprojections, depth measurements d/s - z, ARAP mesh edges
with frozen per-vertex rotations and the global-alignment term, and the
depth-scale priors. Tangent [p1 (3N), p2 (3N), s1, s2, xi (6)].

Up to ``DENSE_DIM_LIMIT`` the damped system is the dense J^T J solved by an
equilibrated Cholesky with one refinement step; above it, a block-sparse
J^T J (per-point 6x6 blocks, neighbour blocks, point-global coupling)
solved by block-Jacobi preconditioned CG from zero with ``CG_RTOL`` and
``CG_ITERS``. Everything is plain PyTorch; nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from . import geometry as G
from .mesh import build_mesh

HUBER_DELTA = math.sqrt(100.991)
TINY = 1e-30
TAU = 1e-5
MAX_TRIALS = 10
DENSE_DIM_LIMIT = 4096
CG_ITERS = 64
CG_RTOL = 1e-2


class PairData(NamedTuple):
    kp1: torch.Tensor
    kp2: torch.Tensor
    depth1: torch.Tensor
    depth2: torch.Tensor
    valid: torch.Tensor
    cam: torch.Tensor
    R1w: torch.Tensor
    t1w: torch.Tensor
    R2w: torch.Tensor
    t2w: torch.Tensor
    nbr: torch.Tensor
    nbr_mask: torch.Tensor
    wcot: torch.Tensor
    Ri: torch.Tensor
    area: torch.Tensor
    ntri: torch.Tensor
    s1_prior: torch.Tensor
    s2_prior: torch.Tensor
    s1_info: torch.Tensor
    s2_info: torch.Tensor


class PairState(NamedTuple):
    p1: torch.Tensor
    p2: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    Rg: torch.Tensor
    tg: torch.Tensor


class Hyper(NamedTuple):
    rep_w: torch.Tensor
    arap_w: torch.Tensor
    depth_sigma: torch.Tensor


class LMResult(NamedTuple):
    state: object
    cost: torch.Tensor
    initial_cost: torch.Tensor
    n_accepted: int
    n_solves: int


def pair_data(kp1, kp2, d1, d2, valid, cam, T1w, T2w, p1, p2, scale_priors, device) -> PairData:
    """Mesh of the valid p1 points, cot weights and frozen rotations; every
    device tensor float32."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    valid = np.asarray(valid, dtype=bool)
    n = len(valid)
    vidx = np.nonzero(valid)[0]
    p1 = np.asarray(p1, dtype=np.float64)
    mesh = build_mesh(p1[vidx])
    nbr = np.full((n, mesh.nbr.shape[1]), -1, dtype=np.int64)
    w = np.zeros((n, mesh.nbr.shape[1]))
    nbr[vidx] = np.where(mesh.nbr >= 0, vidx[np.maximum(mesh.nbr, 0)], -1)
    w[vidx] = mesh.weights
    nbr_t = torch.as_tensor(nbr, device=device)
    mask = nbr_t >= 0
    wcot = t(w)
    Ri = G.compute_rotations(t(p1), t(p2), nbr_t, mask, wcot)
    return PairData(
        kp1=t(kp1), kp2=t(kp2), depth1=t(d1), depth2=t(d2), valid=torch.as_tensor(valid, device=device),
        cam=t(cam), R1w=t(T1w[0]), t1w=t(T1w[1]), R2w=t(T2w[0]), t2w=t(T2w[1]),
        nbr=nbr_t, nbr_mask=mask, wcot=wcot, Ri=Ri, area=t(mesh.surface_area), ntri=t(float(mesh.n_triangles)),
        s1_prior=t(scale_priors[0]), s1_info=t(scale_priors[1]), s2_prior=t(scale_priors[2]),
        s2_info=t(scale_priors[3]),
    )


def tangent_dim(n: int) -> int:
    return 6 * n + 8


def apply_delta(state: PairState, delta):
    n = state.p1.shape[0]
    dR, dt = G.se3_exp(delta[6 * n + 2: 6 * n + 8])
    Rg, tg = G.compose(dR, dt, state.Rg, state.tg)
    return PairState(
        p1=state.p1 + delta[: 3 * n].reshape(n, 3), p2=state.p2 + delta[3 * n: 6 * n].reshape(n, 3),
        s1=state.s1 + delta[6 * n], s2=state.s2 + delta[6 * n + 1], Rg=Rg, tg=tg,
    )


def huber(chi2):
    """(rho, rho') of g2o's Huber kernel on the chi2 scale."""
    d2 = HUBER_DELTA * HUBER_DELTA
    sqrt_c = torch.sqrt(torch.clamp(chi2, min=TINY))
    inside = chi2 <= d2
    return (torch.where(inside, chi2, 2.0 * HUBER_DELTA * sqrt_c - d2),
            torch.where(inside, torch.ones_like(chi2), HUBER_DELTA / sqrt_c))


def depth_error(p, s, R, t, d):
    e = d / s - G.apply(R, t, p)[..., 2]
    return torch.where(s <= 0.0, math.sqrt(500.0) * e, e)


def arap_energies(data: PairData, state: PairState):
    return G.arap_edge_energy(state.p1, state.p2, data.Ri, data.nbr, data.nbr_mask, data.wcot, data.area,
                              state.Rg, state.tg)


def robust_cost(data: PairData, hyper: Hyper, state: PairState):
    vm = data.valid.to(state.p1.dtype)
    e1 = data.kp1 - G.project(data.cam, G.apply(data.R1w, data.t1w, state.p1))
    e2 = data.kp2 - G.project(data.cam, G.apply(data.R2w, data.t2w, state.p2))
    rho1, _ = huber(torch.sum(e1 * e1, dim=-1) * hyper.rep_w)
    rho2, _ = huber(torch.sum(e2 * e2, dim=-1) * hyper.rep_w)
    cost_rep = torch.sum(vm * (rho1 + rho2))
    info_d = 1.0 / (hyper.depth_sigma * hyper.depth_sigma)
    ed1 = depth_error(state.p1, state.s1, data.R1w, data.t1w, data.depth1)
    ed2 = depth_error(state.p2, state.s2, data.R2w, data.t2w, data.depth2)
    cost_depth = torch.sum(vm * info_d * (ed1 * ed1 + ed2 * ed2))
    E = arap_energies(data, state)
    cost = cost_rep + cost_depth + torch.sum(hyper.arap_w * data.ntri * data.ntri * E * E)
    return cost + (data.s1_info * (state.s1 - data.s1_prior) ** 2 + data.s2_info * (state.s2 - data.s2_prior) ** 2)


def _edge_energy(p1i, p2i, p1j, p2j, Ri, Rj, w, area, Rg, tg):
    """ARAP energy of directed edges with the global term, batched."""
    mv = lambda M, v: torch.einsum("...ij,...j->...i", M, v)
    sq = lambda v: torch.sum(v * v, dim=-1)
    d1 = p1i - p1j
    d2 = p2i - p2j
    e = w * (sq((d2 - mv(Ri, d1)) / area) + sq((-d2 - mv(Rj, -d1)) / area))
    g = (mv(Rg, p2i) - tg - p1i) + (mv(Rg, p2j) - tg - p1j)
    return e + sq(g)


def _mesh_slot_jacobian(data: PairData, hyper: Hyper, state: PairState):
    """Weighted slot energies r [N*K] and their Jacobians [N*K, 18] over
    (p1_i, p2_i, p1_j, p2_j, xi), by forward-mode AD along each coordinate."""
    n, K = data.nbr.shape
    dtype, dev = state.p1.dtype, state.p1.device
    j_safe = torch.clamp(data.nbr, min=0)
    w_edge = (data.nbr_mask & data.valid[:, None] & data.valid[j_safe]).to(dtype) * (
        torch.sqrt(hyper.arap_w) * data.ntri)
    Rg0, tg0 = state.Rg, state.tg
    ii = torch.arange(n, device=dev)[:, None].expand(n, K).reshape(-1)
    jj = j_safe.reshape(-1)
    Ri_e, Rj_e = data.Ri[ii], data.Ri[jj]
    wcot_e, we = data.wcot.reshape(-1), w_edge.reshape(-1)

    def local(x):
        dR, dt = G.se3_exp(x[:, 12:18])
        Rg, tg = G.compose(dR, dt, Rg0, tg0)
        return we * _edge_energy(x[:, 0:3], x[:, 3:6], x[:, 6:9], x[:, 9:12], Ri_e, Rj_e, wcot_e, data.area, Rg, tg)

    x_edges = torch.cat([state.p1[ii], state.p2[ii], state.p1[jj], state.p2[jj],
                         torch.zeros((n * K, 6), dtype=dtype, device=dev)], dim=-1)
    basis = torch.eye(18, dtype=dtype, device=dev)[:, None, :].expand(18, n * K, 18)
    L = vmap(lambda v: jvp(local, (x_edges,), (v,))[1])(basis).T
    return L, local(x_edges)


def _edge_blocks(data: PairData, hyper: Hyper, state: PairState):
    """(L [M, rdim, d], r [M, rdim], tangent index [M, d]) of every edge
    family."""
    n = state.p1.shape[0]
    dtype, dev = state.p1.dtype, state.p1.device
    vm = data.valid.to(dtype)
    ar = torch.arange(n, device=dev)
    idx_p1 = 3 * ar[:, None] + torch.arange(3, device=dev)[None, :]
    idx_p2 = 3 * n + idx_p1
    idx_xi = 6 * n + 2 + torch.arange(6, device=dev)
    blocks = []
    for p, R, t, kp, idx_p in ((state.p1, data.R1w, data.t1w, data.kp1, idx_p1),
                               (state.p2, data.R2w, data.t2w, data.kp2, idx_p2)):
        pc = G.apply(R, t, p)
        e = kp - G.project(data.cam, pc)
        _, drho = huber(torch.sum(e * e, dim=-1) * hyper.rep_w)
        w = torch.sqrt(drho * hyper.rep_w) * vm
        L = -w[:, None, None] * torch.einsum("nab,bc->nac", G.project_jac(data.cam, pc), R)
        blocks.append((L, w[:, None] * e, idx_p))
    inv_sigma_d = 1.0 / hyper.depth_sigma
    for p, s, R, t, d, idx_p, i_s in ((state.p1, state.s1, data.R1w, data.t1w, data.depth1, idx_p1, 6 * n),
                                      (state.p2, state.s2, data.R2w, data.t2w, data.depth2, idx_p2, 6 * n + 1)):
        w = vm * inv_sigma_d
        z = (p @ R.T + t)[:, 2]
        pen = torch.where(s <= 0.0, math.sqrt(500.0), 1.0).to(dtype)
        e = pen * (d / s - z)
        de_dz = torch.ones_like(e) * (-pen)
        de_ds = pen * (-d / (s * s))
        L = torch.cat([(w * de_dz)[:, None] * R[2, :][None, :], (w * de_ds)[:, None]], dim=-1)[:, None, :]
        idx = torch.cat([idx_p, torch.full((n, 1), i_s, dtype=idx_p.dtype, device=dev)], dim=-1)
        blocks.append((L, (w * e)[:, None], idx))
    K = data.nbr.shape[1]
    ii = ar[:, None].expand(n, K).reshape(-1)
    jj = torch.clamp(data.nbr, min=0).reshape(-1)
    L, r = _mesh_slot_jacobian(data, hyper, state)
    idx = torch.cat([idx_p1[ii], idx_p2[ii], idx_p1[jj], idx_p2[jj], idx_xi.expand(n * K, 6)], dim=-1)
    blocks.append((L[:, None, :], r[:, None], idx))
    sqrt_i = torch.stack([torch.sqrt(data.s1_info), torch.sqrt(data.s2_info)]).to(dtype)
    r_s = (sqrt_i * torch.stack([state.s1 - data.s1_prior, state.s2 - data.s2_prior]).to(dtype)).reshape(2, 1)
    blocks.append((sqrt_i.reshape(2, 1, 1), r_s, torch.tensor([[6 * n], [6 * n + 1]], dtype=idx_p1.dtype, device=dev)))
    return blocks


def build_system(data: PairData, hyper: Hyper, state: PairState):
    """Dense (H, g) = (J^T J, J^T r), Huber weights frozen at ``state``."""
    dim = tangent_dim(state.p1.shape[0])
    blocks = _edge_blocks(data, hyper, state)
    rows = sum(L.shape[0] * L.shape[1] for L, _, _ in blocks)
    J = torch.zeros((rows, dim), dtype=state.p1.dtype, device=state.p1.device)
    rs = []
    off = 0
    for L, r_, idx in blocks:
        M, rr, dd = L.shape
        J[off: off + M * rr].scatter_(1, idx[:, None, :].expand(M, rr, dd).reshape(M * rr, dd),
                                      L.reshape(M * rr, dd))
        rs.append(r_.reshape(-1))
        off += M * rr
    r = torch.cat(rs)
    return J.T @ J, J.T @ r


def damped_cholesky(H, g, lam):
    """x = -(H + lam I)^-1 g: Jacobi equilibration, Cholesky, one refinement
    step against the unfactored matrix; NaN where the factorization fails."""
    A = H + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), min=TINY))
    Lf, info = torch.linalg.cholesky_ex(A * s[:, None] * s[None, :])
    Lf = torch.where(info != 0, torch.full_like(Lf, float("nan")), Lf)
    solve = lambda rhs: s * torch.cholesky_solve((rhs * s)[:, None], Lf)[:, 0]
    x = solve(-g)
    return x + solve(-g - A @ x)


# --- Block-sparse system and PCG (tangent dim above DENSE_DIM_LIMIT) --------


class BlockSystem(NamedTuple):
    D: torch.Tensor  # [N, 6, 6]
    Bt: torch.Tensor  # [N, K, 6, 6]
    C: torch.Tensor  # [N, 6, 8]
    Hg: torch.Tensor  # [8, 8]
    g_p: torch.Tensor  # [N, 6]
    g_g: torch.Tensor  # [8]


def _arap_slot_jacobian(data: PairData, hyper: Hyper, state: PairState):
    """Closed-form slot Jacobian [N, K, 18] and weighted slot energies [N, K]."""
    n, K = data.nbr.shape
    j_safe = torch.clamp(data.nbr, min=0)
    w_edge = ((data.nbr_mask & data.valid[:, None] & data.valid[j_safe]).to(state.p1.dtype)
              * torch.sqrt(hyper.arap_w) * data.ntri)
    p1j, p2j, Rj = state.p1[j_safe], state.p2[j_safe], data.Ri[j_safe]
    p1i_b = state.p1[:, None, :].expand(n, K, 3)
    p2i_b = state.p2[:, None, :].expand(n, K, 3)
    Ri_b = data.Ri[:, None].expand(n, K, 3, 3)
    d1 = p1i_b - p1j
    d2 = p2i_b - p2j
    inv_area = 1.0 / data.area
    f = (d2 - torch.einsum("nkab,nkb->nka", Ri_b, d1)) * inv_area
    s_ = (-d2 + torch.einsum("nkab,nkb->nka", Rj, d1)) * inv_area
    wcot = data.wcot.to(state.p1.dtype)
    w2a = (2.0 * wcot * inv_area)[..., None]
    rtf = torch.einsum("nkba,nkb->nka", Ri_b, f)
    rts = torch.einsum("nkba,nkb->nka", Rj, s_)
    fs = w2a * (f - s_)
    e_slot = wcot * (torch.sum(f * f, dim=-1) + torch.sum(s_ * s_, dim=-1))
    Rg0, tg0 = state.Rg, state.tg
    ai = p2i_b @ Rg0.T - tg0
    aj = p2j @ Rg0.T - tg0
    g = ai + aj - p1i_b - p1j
    rg_tg = 2.0 * (g @ Rg0)
    g2 = 2.0 * g
    d_om = 2.0 * torch.linalg.cross(ai + aj, g)
    d_up = -4.0 * g
    e_slot = e_slot + torch.sum(g * g, dim=-1)
    Jfull = torch.cat([w2a * (-rtf + rts) - g2, fs + rg_tg, w2a * (rtf - rts) - g2, -fs + rg_tg, d_om, d_up],
                      dim=-1) * w_edge[..., None]
    return Jfull, w_edge * e_slot


def build_block_system(data: PairData, hyper: Hyper, state: PairState) -> BlockSystem:
    """The same linearization as ``build_system`` in block form; every ARAP
    slot energy is symmetric in (i, j), so each point's outgoing slots give
    H with a factor 2."""
    n, K = data.nbr.shape
    dtype, dev = state.p1.dtype, state.p1.device
    vm = data.valid.to(dtype)
    D = torch.zeros((n, 6, 6), dtype=dtype, device=dev)
    C = torch.zeros((n, 6, 8), dtype=dtype, device=dev)
    Hg = torch.zeros((8, 8), dtype=dtype, device=dev)
    g_p = torch.zeros((n, 6), dtype=dtype, device=dev)
    g_g = torch.zeros((8,), dtype=dtype, device=dev)
    for slot, (p, R, t, kp) in enumerate(((state.p1, data.R1w, data.t1w, data.kp1),
                                          (state.p2, data.R2w, data.t2w, data.kp2))):
        pc = G.apply(R, t, p)
        e = kp - G.project(data.cam, pc)
        _, drho = huber(torch.sum(e * e, dim=-1) * hyper.rep_w)
        w = torch.sqrt(drho * hyper.rep_w) * vm
        A = -w[:, None, None] * torch.einsum("nab,bc->nac", G.project_jac(data.cam, pc), R)
        r = w[:, None] * e
        s = 3 * slot
        D[:, s: s + 3, s: s + 3] += torch.einsum("nra,nrb->nab", A, A)
        g_p[:, s: s + 3] += torch.einsum("nra,nr->na", A, r)
    inv_sigma_d = 1.0 / hyper.depth_sigma
    for slot, (p, sc, R, t, d) in enumerate(((state.p1, state.s1, data.R1w, data.t1w, data.depth1),
                                             (state.p2, state.s2, data.R2w, data.t2w, data.depth2))):
        w = vm * inv_sigma_d
        z = (p @ R.T + t)[:, 2]
        pen = torch.where(sc <= 0.0, 500.0**0.5, 1.0).to(dtype)
        e = pen * (d / sc - z)
        de_dz = torch.ones_like(e) * (-pen)
        de_ds = pen * (-d / (sc * sc))
        r = w * e
        ap = (w * de_dz)[:, None] * R[2, :][None, :]
        a_s = w * de_ds
        s = 3 * slot
        D[:, s: s + 3, s: s + 3] += torch.einsum("na,nb->nab", ap, ap)
        C[:, s: s + 3, slot] += ap * a_s[:, None]
        Hg[slot, slot] += torch.sum(a_s * a_s)
        g_p[:, s: s + 3] += ap * r[:, None]
        g_g[slot] += torch.sum(a_s * r)
    Jfull, r_slot = _arap_slot_jacobian(data, hyper, state)
    Ji, Jj, Jx = Jfull[..., 0:6], Jfull[..., 6:12], Jfull[..., 12:18]
    D = D + 2.0 * torch.einsum("nka,nkb->nab", Ji, Ji)
    Bt = 2.0 * torch.einsum("nka,nkb->nkab", Ji, Jj)
    C[:, :, 2:8] += 2.0 * torch.einsum("nka,nkg->nag", Ji, Jx)
    Hg[2:8, 2:8] += torch.einsum("nka,nkb->ab", Jx, Jx)
    g_p = g_p + 2.0 * torch.einsum("nka,nk->na", Ji, r_slot)
    g_g[2:8] += torch.einsum("nka,nk->a", Jx, r_slot)
    for col, (sc, prior, info) in enumerate(((state.s1, data.s1_prior, data.s1_info),
                                             (state.s2, data.s2_prior, data.s2_info))):
        Hg[col, col] += info
        g_g[col] += info * (sc - prior)
    return BlockSystem(D=D, Bt=Bt, C=C, Hg=Hg, g_p=g_p, g_g=g_g)


def _split(v, n):
    return torch.cat([v[: 3 * n].reshape(n, 3), v[3 * n: 6 * n].reshape(n, 3)], dim=-1), v[6 * n:]


def _join(y_p, y_g):
    return torch.cat([y_p[:, 0:3].reshape(-1), y_p[:, 3:6].reshape(-1), y_g])


def block_matvec(sys: BlockSystem, nbr, v, lam):
    n = sys.D.shape[0]
    v_p, v_g = _split(v, n)
    vj = v_p[torch.clamp(nbr, min=0)]
    y_p = (torch.einsum("nab,nb->na", sys.D, v_p) + torch.einsum("nkab,nkb->na", sys.Bt, vj)
           + torch.einsum("nag,g->na", sys.C, v_g))
    y_g = torch.einsum("nag,na->g", sys.C, v_p) + sys.Hg @ v_g
    return _join(y_p, y_g) + lam * v


def inv6_spd(M):
    """Batched 6x6 SPD inverse: equilibrate, Cholesky, L^-1, Li^T Li."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1), min=TINY))
    Ms = M * s[..., :, None] * s[..., None, :]
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            acc = Ms[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(acc, min=TINY)) if i == j else acc / L[j][j]
    Li = [[None] * 6 for _ in range(6)]
    for i in range(6):
        Li[i][i] = 1.0 / L[i][i]
        for j in range(i - 1, -1, -1):
            acc = L[i][j] * Li[j][j]
            for k in range(j + 1, i):
                acc = acc + L[i][k] * Li[k][j]
            Li[i][j] = -acc * Li[i][i]
    rows = []
    for a in range(6):
        cols = []
        for b in range(6):
            acc = None
            for k in range(max(a, b), 6):
                term = Li[k][a] * Li[k][b]
                acc = term if acc is None else acc + term
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2) * s[..., :, None] * s[..., None, :]


def pcg(sys: BlockSystem, nbr, b, lam, iters=CG_ITERS, rtol=CG_RTOL):
    """Block-Jacobi PCG for (H + lam I) x = b from x = 0; stops when
    ||r|| <= rtol ||b|` or after ``iters`` iterations."""
    n = sys.D.shape[0]
    eye6 = torch.eye(6, dtype=sys.D.dtype, device=sys.D.device)
    Dinv = inv6_spd(sys.D + lam * eye6[None])
    Hginv = torch.linalg.inv(sys.Hg + lam * torch.eye(8, dtype=sys.Hg.dtype, device=sys.Hg.device))

    def precond(r):
        r_p, r_g = _split(r, n)
        return _join(torch.einsum("nab,nb->na", Dinv, r_p), Hginv @ r_g)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    tol2 = rtol * rtol * torch.dot(b, b)
    k = 0
    while k < iters and bool(torch.dot(r, r) > tol2):
        Ap = block_matvec(sys, nbr, p, lam)
        rz = torch.dot(r, z)
        alpha = rz / (torch.dot(p, Ap) + TINY)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        beta = torch.dot(r, z) / (rz + TINY)
        p = z + beta * p
        k += 1
    return x


# --- Levenberg-Marquardt ----------------------------------------------------


def lm(make_step, cost, apply, state0, n_iterations) -> LMResult:
    """g2o-style damping: lambda0 = TAU max diag H; gain ratio
    rho = (F0 - F1) / (delta . (lambda delta - g)); accept if rho > 0 and F1
    is finite (lambda *= max(1/3, 1 - (2 rho - 1)^3), nu = 2), else
    lambda *= nu, nu *= 2; an iteration whose MAX_TRIALS trials all fail
    ends the solve."""
    F0 = cost(state0)
    state, F = state0, F0
    lam = torch.full((), -1.0, dtype=F.dtype, device=F.device)
    nu = torch.full((), 2.0, dtype=F.dtype, device=F.device)
    n_acc = n_solves = 0
    for _ in range(n_iterations):
        solve, g, diag_max = make_step(state)
        lam = torch.where(lam < 0, TAU * diag_max, lam)
        accepted = False
        for _ in range(MAX_TRIALS):
            delta = solve(lam)
            n_solves += 1
            cand = apply(state, delta)
            F1 = cost(cand)
            rho = (F - F1) / (torch.dot(delta, lam * delta - g) + TINY)
            if bool((rho > 0) & torch.isfinite(F1)):
                lam = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                nu = torch.full_like(nu, 2.0)
                state, F = cand, F1
                accepted = True
                break
            lam = lam * nu
            nu = 2.0 * nu
        if not accepted:
            break
        n_acc += 1
    return LMResult(state=state, cost=F, initial_cost=F0, n_accepted=n_acc, n_solves=n_solves)


def solve_pair(data: PairData, hyper: Hyper, state0: PairState, n_iterations: int) -> LMResult:
    """One inner solve: dense normal equations up to DENSE_DIM_LIMIT, the
    block system and PCG above it."""
    cost = lambda s: robust_cost(data, hyper, s)
    if tangent_dim(state0.p1.shape[0]) > DENSE_DIM_LIMIT:

        def make_step(state):
            sys = build_block_system(data, hyper, state)
            g = _join(sys.g_p, sys.g_g)
            diag = _join(torch.diagonal(sys.D, dim1=-2, dim2=-1), torch.diagonal(sys.Hg))
            return (lambda lam: pcg(sys, data.nbr, -g, lam)), g, torch.max(diag)
    else:

        def make_step(state):
            H, g = build_system(data, hyper, state)
            return (lambda lam: damped_cholesky(H, g, lam)), g, torch.max(torch.diagonal(H))

    return lm(make_step, cost, apply_delta, state0, n_iterations)


# --- Rigid hypothesis: p2 = Rr p1 + tr, tangent [p1 (3N), s1, s2, xi] -------


class RigidState(NamedTuple):
    p1: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    Rr: torch.Tensor
    tr: torch.Tensor


def _p2_of(state: RigidState):
    return state.p1 @ state.Rr.T + state.tr


def apply_delta_rigid(state: RigidState, delta):
    n = state.p1.shape[0]
    dR, dt = G.se3_exp(delta[3 * n + 2: 3 * n + 8])
    Rr, tr = G.compose(dR, dt, state.Rr, state.tr)
    return RigidState(p1=state.p1 + delta[: 3 * n].reshape(n, 3), s1=state.s1 + delta[3 * n],
                      s2=state.s2 + delta[3 * n + 1], Rr=Rr, tr=tr)


def _residuals_rigid(data: PairData, hyper: Hyper, state: RigidState):
    vm = data.valid.to(state.p1.dtype)
    p2 = _p2_of(state)

    def rep(p, R, t, kp):
        e = kp - G.project(data.cam, G.apply(R, t, p))
        _, drho = huber(torch.sum(e * e, dim=-1).detach() * hyper.rep_w)
        w = torch.sqrt(drho * hyper.rep_w) * vm
        return (w[:, None] * e).reshape(-1)

    inv_sigma_d = 1.0 / hyper.depth_sigma
    return torch.cat([
        rep(state.p1, data.R1w, data.t1w, data.kp1),
        rep(p2, data.R2w, data.t2w, data.kp2),
        vm * inv_sigma_d * depth_error(state.p1, state.s1, data.R1w, data.t1w, data.depth1),
        vm * inv_sigma_d * depth_error(p2, state.s2, data.R2w, data.t2w, data.depth2),
        torch.stack([torch.sqrt(data.s1_info) * (state.s1 - data.s1_prior),
                     torch.sqrt(data.s2_info) * (state.s2 - data.s2_prior)]),
    ])


def robust_cost_rigid(data: PairData, hyper: Hyper, state: RigidState):
    vm = data.valid.to(state.p1.dtype)
    p2 = _p2_of(state)

    def rep(p, R, t, kp):
        e = kp - G.project(data.cam, G.apply(R, t, p))
        rho, _ = huber(torch.sum(e * e, dim=-1) * hyper.rep_w)
        return torch.sum(vm * rho)

    cost = rep(state.p1, data.R1w, data.t1w, data.kp1)
    cost = cost + rep(p2, data.R2w, data.t2w, data.kp2)
    info_d = 1.0 / (hyper.depth_sigma * hyper.depth_sigma)
    ed1 = depth_error(state.p1, state.s1, data.R1w, data.t1w, data.depth1)
    ed2 = depth_error(p2, state.s2, data.R2w, data.t2w, data.depth2)
    cost = cost + torch.sum(vm * info_d * (ed1 * ed1 + ed2 * ed2))
    cost = cost + data.s1_info * (state.s1 - data.s1_prior) ** 2
    return cost + data.s2_info * (state.s2 - data.s2_prior) ** 2


def build_system_rigid(data: PairData, hyper: Hyper, state: RigidState):
    """Dense (J^T J, J^T r) of the rigid model; J by forward-mode AD."""
    def f(delta):
        r = _residuals_rigid(data, hyper, apply_delta_rigid(state, delta))
        return r, r

    zero = torch.zeros((3 * state.p1.shape[0] + 8,), dtype=state.p1.dtype, device=state.p1.device)
    J, r = jacfwd(f, has_aux=True)(zero)
    return J.T @ J, J.T @ r


def pixel_sigmas(data: PairData, p1, p2):
    """Per camera, the mean over u and v of the rms pixel error."""
    vm = data.valid.to(p1.dtype)
    n = torch.clamp(torch.sum(vm), min=1.0)

    def desv(p, R, t, kp):
        e = kp - G.project(data.cam, G.apply(R, t, p))
        return torch.mean(torch.sqrt(torch.sum(vm[:, None] * e * e, dim=0) / n))

    return desv(p1, data.R1w, data.t1w, data.kp1), desv(p2, data.R2w, data.t2w, data.kp2)


def depth_discrepancy(data: PairData, p1, p2, s1, s2):
    """Per camera, rms(d / s - z)."""
    vm = data.valid.to(p1.dtype)
    n = torch.clamp(torch.sum(vm), min=1.0)

    def rms(p, s, R, t, d):
        e = d / torch.clamp(s, min=TINY) - G.apply(R, t, p)[..., 2]
        return torch.sqrt(torch.sum(vm * e * e) / n)

    return rms(p1, s1, data.R1w, data.t1w, data.depth1), rms(p2, s2, data.R2w, data.t2w, data.depth2)


def _midpoint_p1(data: PairData, Rr, tr, p1_fallback):
    """Closed-form two-view midpoint of p1 given the scene motion."""
    def ray(R, t, kp):
        xn = G.unproject(data.cam, kp)
        return -R.T @ t, (xn / torch.linalg.norm(xn, dim=-1, keepdim=True)) @ R

    c1, d1 = ray(data.R1w, data.t1w, data.kp1)
    c2, d2 = ray(data.R2w @ Rr, data.R2w @ tr + data.t2w, data.kp2)
    eye = torch.eye(3, dtype=p1_fallback.dtype, device=p1_fallback.device)
    A1 = eye[None] - d1[:, :, None] * d1[:, None, :]
    A2 = eye[None] - d2[:, :, None] * d2[:, None, :]
    p = torch.linalg.solve(A1 + A2 + 1e-6 * eye[None], (A1 @ c1 + A2 @ c2)[..., None]).squeeze(-1)
    use = ((torch.sum(d1 * d2, dim=-1) < 0.9999) & torch.all(torch.isfinite(p), dim=-1) & data.valid)[:, None]
    return torch.where(use, p, p1_fallback)


def _rigid_round(data: PairData, hyper: Hyper, state: PairState, n_iterations, count):
    vm = data.valid.to(state.p1.dtype)
    R, _ = G.kabsch(state.p1, state.p2, vm)
    wsum = torch.clamp(torch.sum(vm), min=1.0)
    c1 = torch.sum(vm[:, None] * state.p1, dim=0) / wsum
    c2 = torch.sum(vm[:, None] * state.p2, dim=0) / wsum
    tr = c2 - R @ c1

    def scale_anchor(p, Rw, t, d):
        ratio = d / torch.clamp(G.apply(Rw, t, p)[..., 2], min=TINY)
        m = torch.sum(vm * ratio) / wsum
        var = torch.sum(vm * (ratio - m) ** 2) / wsum
        se = torch.sqrt(torch.clamp(var / wsum, min=1e-12))
        return m, 1.0 / (se * se)

    s1p, s1i = scale_anchor(state.p1, data.R1w, data.t1w, data.depth1)
    s2p, s2i = scale_anchor(state.p2, data.R2w, data.t2w, data.depth2)
    data = data._replace(s1_prior=s1p, s1_info=s1i, s2_prior=s2p, s2_info=s2i)
    best = best_cost = None
    for p1_init in (state.p1, _midpoint_p1(data, R, tr, state.p1)):
        res = lm(lambda s: (lambda H, g: ((lambda lam: damped_cholesky(H, g, lam)), g, torch.max(torch.diagonal(H))))(
                     *build_system_rigid(data, hyper, s)),
                 lambda s: robust_cost_rigid(data, hyper, s), apply_delta_rigid,
                 RigidState(p1=p1_init, s1=s1p, s2=s2p, Rr=R, tr=tr), n_iterations)
        count(res)
        if best is None or bool(res.cost < best_cost):
            best, best_cost = res.state, res.cost
    p2 = _p2_of(best)
    Rg = best.Rr.T
    cand = PairState(p1=best.p1, p2=p2, s1=best.s1, s2=best.s2, Rg=Rg, tg=Rg @ best.tr)
    sig = pixel_sigmas(data, best.p1, p2)
    dep = depth_discrepancy(data, best.p1, p2, best.s1, best.s2)
    return cand, (sig[0], sig[1], dep[0], dep[1])


def solve_rigid(data: PairData, hyper: Hyper, state0: PairState, n_iterations: int, count, max_restarts=5):
    """Restarted two-start rigid LM; returns (candidate PairState,
    (sigma1, sigma2, depth_rms1, depth_rms2))."""
    sigma_d = torch.clamp(hyper.depth_sigma, min=TINY)
    score = lambda d: float(d[0] ** 2 + d[1] ** 2 + (d[2] ** 2 + d[3] ** 2) / (sigma_d * sigma_d))
    cur, best, best_score = state0, None, np.inf
    for _ in range(max_restarts):
        cand, diag = _rigid_round(data, hyper, cur, n_iterations, count)
        s = score(diag)
        if not np.isfinite(s) or s >= best_score - 1e-9:
            break
        best, best_score = (cand, diag), s
        cur = cand
    return best if best is not None else (cand, diag)
