"""Explicit block-sparse Gauss-Newton system for the large-N pair solve.

Counterpart of ``triangulation_in_deformable_scenes_tpu/models/block_system.py``
(see its docstring for the derivation). The operator H = J^T J of
``deformable.build_system`` is assembled once per LM linearization in its
ELLPACK block form over the packed per-point tangent (p1_i, p2_i):

- ``D``  [N, 6, 6]    per-point diagonal blocks;
- ``Bt`` [N, K, 6, 6] neighbour coupling blocks aligned with ``data.nbr``;
- ``C``  [N, 6, 8]    point-to-global coupling (s1, s2, xi[6]);
- ``Hg`` [8, 8]       global block; plus the gradient (``g_p``, ``g_g``).

Every mesh-edge energy of the model family is symmetric under (i, j), so all
of H assembles from each point's outgoing slots with a factor 2 and no
scatter. Each damped trial is then solved by block-Jacobi PCG
(``ops/block_pcg.py``): the hand-written CUDA kernel for a CUDA tensor, the
plain loop ``pcg_flex`` over ``block_matvec`` and ``block_jacobi_apply`` for
a CPU tensor.

The flat tangent layout is the solver's: [p1 (3N), p2 (3N), s1, s2, xi (6)].
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import tracing
from ..ops import block_pcg
from ..ops import camera as cam_ops
from ..ops import lie
from ..precision import TINY
from . import deformable as D_


class BlockSystem(NamedTuple):
    D: torch.Tensor    # [N, 6, 6]
    Bt: torch.Tensor   # [N, K, 6, 6]
    C: torch.Tensor    # [N, 6, 8]
    Hg: torch.Tensor   # [8, 8]
    g_p: torch.Tensor  # [N, 6]
    g_g: torch.Tensor  # [8]


def _arap_slot_jacobian(data: D_.PairData, hyper: D_.Hyper, state: D_.PairState, spec: D_.ModelSpec,
                        src: D_.NeighbourSource = None):
    """Analytic slot Jacobian Jfull [N, K, 18] and weighted slot energies
    r [N, K] of the ARAP family (``block_system.py:204-261``): the edge's
    inner residuals are linear in the points,

        f = (d2 - Ri d1) / area,  s = (-d2 + Rj d1) / area,
        g = Rg (p2i + p2j) - 2 tg - p1i - p1j             (use_global)

    with d1 = p1i - p1j, d2 = p2i - p2j, and the xi block takes the se3_exp
    first-order terms at 0 composed left of (Rg0, tg0)."""
    n, K = data.nbr.shape
    p1s, p2s, Ris, valids = D_._neighbours(data, state, src)
    j_safe = torch.clamp(data.nbr, min=0)
    w_edge = (
        (data.nbr_mask & data.valid[:, None] & valids[j_safe]).to(state.p1.dtype)
        * torch.sqrt(hyper.arap_w)
        * data.ntri
    )
    p1j, p2j = p1s[j_safe], p2s[j_safe]
    Rj = Ris[j_safe]
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
    rtf = torch.einsum("nkba,nkb->nka", Ri_b, f)  # Ri^T f
    rts = torch.einsum("nkba,nkb->nka", Rj, s_)  # Rj^T s
    fs = w2a * (f - s_)
    e_slot = wcot * (torch.sum(f * f, dim=-1) + torch.sum(s_ * s_, dim=-1))
    if spec.use_global:
        Rg0, tg0 = state.Rg, state.tg
        ai = p2i_b @ Rg0.T - tg0
        aj = p2j @ Rg0.T - tg0
        g = ai + aj - p1i_b - p1j
        rg_tg = 2.0 * (g @ Rg0)  # 2 Rg0^T g
        g2 = 2.0 * g
        d_om = 2.0 * torch.linalg.cross(ai + aj, g)
        d_up = -4.0 * g
        e_slot = e_slot + torch.sum(g * g, dim=-1)
    else:
        rg_tg = g2 = d_om = d_up = torch.zeros_like(f)
    Jfull = torch.cat(
        [
            w2a * (-rtf + rts) - g2,  # d/d p1i
            fs + rg_tg,               # d/d p2i
            w2a * (rtf - rts) - g2,   # d/d p1j
            -fs + rg_tg,              # d/d p2j
            d_om,                     # d/d omega
            d_up,                     # d/d upsilon
        ],
        dim=-1,
    ) * w_edge[..., None]
    return Jfull, w_edge * e_slot


def build_block_system(
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    state: D_.PairState,
    spec: D_.ModelSpec = D_.ModelSpec(),
    src: D_.NeighbourSource = None,
) -> BlockSystem:
    """(H, g) at ``state`` in block-sparse form (``block_system.py:72-299``):
    the same linearization as ``deformable.build_system`` (robust weights
    frozen at ``state``). With ``src`` (``deformable.NeighbourSource``) the
    rows are a landmark shard's and their neighbours are read from it."""
    with tracing.span("assembly"):
        n, K = data.nbr.shape
        dtype, dev = state.p1.dtype, state.p1.device
        vm = data.valid.to(dtype)

        D = torch.zeros((n, 6, 6), dtype=dtype, device=dev)
        C = torch.zeros((n, 6, 8), dtype=dtype, device=dev)
        Hg = torch.zeros((8, 8), dtype=dtype, device=dev)
        g_p = torch.zeros((n, 6), dtype=dtype, device=dev)
        g_g = torch.zeros((8,), dtype=dtype, device=dev)

        # Reprojection edges, Huber IRLS weights frozen at state; closed-form
        # Jacobian de/dp = -(dproj/dpc) R.
        for slot, (p, R, t, kp, inv_s2) in enumerate((
            (state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1),
            (state.p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2),
        )):
            pc = lie.apply(R, t, p)
            e = kp - cam_ops.project(cam_kind, data.cam_params, pc)
            chi2 = torch.sum(e * e, dim=-1) * inv_s2 * hyper.rep_w
            _, drho = D_._huber_rho(chi2)
            w = torch.sqrt(drho * inv_s2 * hyper.rep_w) * vm
            Jpi = cam_ops.project_jac(cam_kind, data.cam_params, pc)  # [N, 2, 3]
            A = -w[:, None, None] * torch.einsum("nab,bc->nac", Jpi, R)  # [N, 2, 3]
            r = w[:, None] * e
            s = 3 * slot
            D[:, s : s + 3, s : s + 3] += torch.einsum("nra,nrb->nab", A, A)
            g_p[:, s : s + 3] += torch.einsum("nra,nr->na", A, r)

        # Depth edges, closed form: every mode's e depends on p only through
        # z = (R p + t)[2], so de/dp = (de/dz) R[2, :] and de/ds is scalar.
        if spec.depth != "none":
            inv_sigma_d = 1.0 / hyper.depth_sigma
            for slot, (p, sc, R, t, d) in enumerate((
                (state.p1, state.s1, data.R1w, data.t1w, data.depth1),
                (state.p2, state.s2, data.R2w, data.t2w, data.depth2),
            )):
                w = vm * inv_sigma_d
                z = (p @ R.T + t)[:, 2]
                if spec.depth == "fixed":
                    e = d - z * sc
                    de_dz = torch.ones_like(e) * (-sc)
                    de_ds = torch.zeros_like(e)
                elif spec.depth == "fixed_squared":
                    u = d - z * sc
                    e = u * u
                    de_dz = -2.0 * u * sc
                    de_ds = torch.zeros_like(e)
                elif spec.depth == "scaled_squared":
                    u = d / sc - z
                    pen = torch.where(sc <= 0.0, 500.0, 1.0).to(dtype)
                    e = pen * u * u
                    de_dz = pen * (-2.0 * u)
                    de_ds = pen * (-2.0 * u * d / (sc * sc))
                else:  # "scaled": linear residual
                    pen = torch.where(sc <= 0.0, 500.0**0.5, 1.0).to(dtype)
                    e = pen * (d / sc - z)
                    de_dz = torch.ones_like(e) * (-pen)
                    de_ds = pen * (-d / (sc * sc))
                r = w * e
                ap = (w * de_dz)[:, None] * R[2, :][None, :]  # [N, 3]
                a_s = w * de_ds
                s = 3 * slot
                D[:, s : s + 3, s : s + 3] += torch.einsum("na,nb->nab", ap, ap)
                C[:, s : s + 3, slot] += ap * a_s[:, None]
                Hg[slot, slot] += torch.sum(a_s * a_s)
                g_p[:, s : s + 3] += ap * r[:, None]
                g_g[slot] += torch.sum(a_s * r)

        # Mesh edges: per-slot scalar energy, symmetric in (i, j). The Elastic
        # and Ogden families take the forward-mode slot Jacobian of
        # ``deformable._mesh_slot_jacobian`` (``block_system.py:262-268``).
        if spec.energy == "ARAP":
            Jfull, r_slot = _arap_slot_jacobian(data, hyper, state, spec, src)
        else:
            L, r = D_._mesh_slot_jacobian(data, hyper, state, spec, src)
            Jfull, r_slot = L.reshape(n, K, 18), r.reshape(n, K)
        Ji, Jj, Jx = Jfull[..., 0:6], Jfull[..., 6:12], Jfull[..., 12:18]
        D = D + 2.0 * torch.einsum("nka,nkb->nab", Ji, Ji)
        Bt = 2.0 * torch.einsum("nka,nkb->nkab", Ji, Jj)
        C[:, :, 2:8] += 2.0 * torch.einsum("nka,nkg->nag", Ji, Jx)
        Hg[2:8, 2:8] += torch.einsum("nka,nkb->ab", Jx, Jx)
        g_p = g_p + 2.0 * torch.einsum("nka,nk->na", Ji, r_slot)
        g_g[2:8] += torch.einsum("nka,nk->a", Jx, r_slot)

        # Depth-scale prior edges (zero info => inert).
        if spec.depth in ("scaled", "scaled_squared"):
            for col, (sc, prior, info) in enumerate((
                (state.s1, data.s1_prior, data.s1_info),
                (state.s2, data.s2_prior, data.s2_info),
            )):
                Hg[col, col] += info
                g_g[col] += info * (sc - prior)

        if spec.one_set:
            # Frozen first set: zero p1's rows and columns of H and its gradient
            # entries (damping keeps the diagonal nonsingular).
            m = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], dtype=dtype, device=dev)
            D = D * m[None, :, None] * m[None, None, :]
            Bt = Bt * m[None, None, :, None] * m[None, None, None, :]
            C = C * m[None, :, None]
            g_p = g_p * m[None, :]

        return BlockSystem(D=D, Bt=Bt, C=C, Hg=Hg, g_p=g_p, g_g=g_g)


def _split(v: torch.Tensor, n: int):
    """Flat tangent [p1 (3N), p2 (3N), s1, s2, xi (6)] -> packed ([N, 6], [8])."""
    v_p = torch.cat([v[: 3 * n].reshape(n, 3), v[3 * n : 6 * n].reshape(n, 3)], dim=-1)
    return v_p, v[6 * n :]


def _join(y_p: torch.Tensor, y_g: torch.Tensor) -> torch.Tensor:
    return torch.cat([y_p[:, 0:3].reshape(-1), y_p[:, 3:6].reshape(-1), y_g])


def block_matvec(sys: BlockSystem, nbr: torch.Tensor, v: torch.Tensor, lam) -> torch.Tensor:
    """(H + lam I) v with v in the flat [6N + 8] tangent layout."""
    n = sys.D.shape[0]
    v_p, v_g = _split(v, n)
    vj = v_p[torch.clamp(nbr, min=0)]  # [N, K, 6]: the only gather
    y_p = (
        torch.einsum("nab,nb->na", sys.D, v_p)
        + torch.einsum("nkab,nkb->na", sys.Bt, vj)
        + torch.einsum("nag,g->na", sys.C, v_g)
    )
    y_g = torch.einsum("nag,na->g", sys.C, v_p) + sys.Hg @ v_g
    return _join(y_p, y_g) + lam * v


def flat_gradient(sys: BlockSystem) -> torch.Tensor:
    return _join(sys.g_p, sys.g_g)


def diag_of(sys: BlockSystem) -> torch.Tensor:
    return _join(torch.diagonal(sys.D, dim1=-2, dim2=-1), torch.diagonal(sys.Hg))


def inv6_spd(M: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 SPD inverse (``block_system.py:335-390``): equilibrate,
    unrolled Cholesky, L^-1 by forward substitution, then Li^T Li. The CUDA
    kernel of ``ops/block_pcg.py`` computes the same steps per point."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1), min=TINY))
    Ms = M * s[..., :, None] * s[..., None, :]

    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            acc = Ms[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(acc, min=TINY))
            else:
                L[i][j] = acc / L[j][j]

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
    inv = torch.stack(rows, dim=-2)
    return inv * s[..., :, None] * s[..., None, :]


def block_jacobi_apply(sys: BlockSystem, lam) -> Callable:
    """Block-Jacobi preconditioner (``block_system.py:393-409``): the
    ``inv6_spd`` inverse of (D_i + lam I) per point and the inverse of
    (Hg + lam I), applied as batched 6x6 / 8x8 products."""
    n = sys.D.shape[0]
    eye6 = torch.eye(6, dtype=sys.D.dtype, device=sys.D.device)
    Dinv = inv6_spd(sys.D + lam * eye6[None])
    Hginv = torch.linalg.inv(sys.Hg + lam * torch.eye(8, dtype=sys.Hg.dtype, device=sys.Hg.device))

    def apply(r):
        r_p, r_g = _split(r, n)
        return _join(torch.einsum("nab,nb->na", Dinv, r_p), Hginv @ r_g)

    return apply


def pcg_flex(matvec: Callable, b: torch.Tensor, precond: Callable, iters: int, rtol: float = 1e-3):
    """Preconditioned CG from x0 = 0 with early exit on ||r|| <= rtol ||b||
    and ``iters`` as the hard cap (``block_system.py:412-443``), as a host
    loop. Returns (x, iterations taken); the JAX loop keeps the count in its
    carry and returns x only."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    tol2 = rtol * rtol * torch.dot(b, b)
    k = 0
    while k < iters and tracing.read(torch.dot(r, r) > tol2, bool):
        Ap = matvec(p)
        rz = torch.dot(r, z)
        alpha = rz / (torch.dot(p, Ap) + TINY)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        beta = torch.dot(r, z) / (rz + TINY)
        p = z + beta * p
        k += 1
    return x, k


def make_block_step(
    cam_kind: str,
    data: D_.PairData,
    hyper: D_.Hyper,
    spec: D_.ModelSpec,
    cg_iters: int,
    cg_rtol: float = 1e-3,
) -> Callable:
    """LM step factory for ``ops.lm.lm_optimize_general``
    (``block_system.py:446-475``): assemble the block system once per
    linearization and solve each damped trial by block-Jacobi PCG, on the
    card with the CUDA kernel."""

    def make_step(state):
        sys = build_block_system(cam_kind, data, hyper, state, spec)
        g = flat_gradient(sys)
        diag_max = torch.max(diag_of(sys))

        def solve(lam):
            return block_pcg.pcg_block_system(sys, data.nbr, -g, lam, cg_iters, cg_rtol)

        return solve, g, diag_max

    return make_step
