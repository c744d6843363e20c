"""Deformation-regularized dual-point refinement over one keyframe pair.

Counterpart of ``triangulation_in_deformable_scenes_tpu/models/deformable.py``
(the reference's g2o ``arapOptimization``): state theta = (p1[N,3], p2[N,3],
s1, s2, T_global in SE3), reprojection edges (Huber), depth edges, ARAP (or
Elastic/Ogden) mesh edges and the depth-scale prior edges; the mesh and the
per-vertex rotations are frozen during the LM iterations.

Ported here: ``ModelSpec``/``MODELS``/``model_depth_sigma`` (:51-126), the
state and data tuples (:129-207), ``apply_delta_spec`` (:233-244), every
residual (:247-447), ``_edge_blocks`` and ``build_system`` (:468-714),
``build_system_jacfwd`` (:632-660), ``assemble_diag`` (:717-737), the
backend dispatch and ``solve_pair`` (:744-823), the serving drivers
``solve_pairs`` and ``solve_pairs_pipelined`` (:826-961) and
``make_pair_data`` (:964-1042). Per-edge local Jacobians come
from forward-mode AD (``torch.func.jvp`` along each of the 18 coordinates an
edge touches), the counterpart of ``jax.jacfwd`` under ``jax.vmap`` there.
Above ``DENSE_DIM_LIMIT`` ``solve_pair`` runs the block-sparse backend of
``models/block_system.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from .. import tracing
from ..ops import arap as arap_ops
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import lm as lm_ops
from ..ops import mesh as mesh_ops
from ..precision import FP, TINY

HUBER_DELTA = float(np.sqrt(100.991))  # deltaMono, g2oBundleAdjustment.cc:631


class ModelSpec(NamedTuple):
    """Static structure of the deformation model (see the JAX package's
    ``ModelSpec`` docstring, ``deformable.py:51-97``, for each field)."""

    energy: str = "ARAP"
    depth: str = "scaled"
    one_set: bool = False
    use_global: bool = True


MODELS = {
    "ARAP": ModelSpec(),
    "ARAP_NoGlobal": ModelSpec(use_global=False),
    "ARAP_OneSet": ModelSpec(one_set=True),
    "ARAP_not_scaled_depth": ModelSpec(depth="fixed"),
    "ARAP_depth_onlyTriang": ModelSpec(depth="none"),
    "ARAP_depth_1mm": ModelSpec(),
    "ARAP_depth_3mm": ModelSpec(),
    "ARAP_depth_8mm": ModelSpec(),
    "ARAP_squared_depth": ModelSpec(depth="scaled_squared"),
    "ARAP_not_scaled_depth_squared": ModelSpec(depth="fixed_squared"),
    "Elastic": ModelSpec(energy="Elastic"),
    "HyperElasticOdgen": ModelSpec(energy="Ogden"),
}


def model_depth_sigma(name: str):
    """Depth-uncertainty override (meters) for the ARAP_depth_<x>mm models."""
    if name.startswith("ARAP_depth_") and name.endswith("mm"):
        return float(name[len("ARAP_depth_") : -2]) / 1000.0
    return None


class PairData(NamedTuple):
    """Fixed observations for one keyframe pair (``deformable.py:129-162``)."""

    kp1: torch.Tensor  # [N, 2]
    kp2: torch.Tensor
    inv_sigma2_1: torch.Tensor  # [N]
    inv_sigma2_2: torch.Tensor
    depth1: torch.Tensor  # [N]
    depth2: torch.Tensor
    valid: torch.Tensor  # [N] bool
    cam_params: torch.Tensor  # [8]
    R1w: torch.Tensor
    t1w: torch.Tensor
    R2w: torch.Tensor
    t2w: torch.Tensor
    nbr: torch.Tensor  # [N, K] int64, -1 padded
    nbr_mask: torch.Tensor  # [N, K] bool
    wcot: torch.Tensor  # [N, K]
    Ri: torch.Tensor  # [N, 3, 3]
    area: torch.Tensor  # scalar
    ntri: torch.Tensor  # scalar
    s1_prior: torch.Tensor
    s2_prior: torch.Tensor
    s1_info: torch.Tensor
    s2_info: torch.Tensor


class PairState(NamedTuple):
    p1: torch.Tensor  # [N, 3]
    p2: torch.Tensor
    s1: torch.Tensor  # scalar
    s2: torch.Tensor
    Rg: torch.Tensor  # [3, 3]
    tg: torch.Tensor  # [3]


class NeighbourSource(NamedTuple):
    """Where the mesh-edge terms read a neighbour j: the whole pair's p1,
    p2 [N, 3], Ri [N, 3, 3] and valid [N], indexed by ``data.nbr``. Without
    one (the default) they read ``state`` and ``data`` themselves; a rank
    that holds only its own rows of a landmark-sharded pair
    (``parallel/dist.py``) passes the whole arrays it exchanged."""

    p1: torch.Tensor
    p2: torch.Tensor
    Ri: torch.Tensor
    valid: torch.Tensor


def _neighbours(data, state, src):
    if src is None:
        return state.p1, state.p2, data.Ri, data.valid
    return src


class Hyper(NamedTuple):
    rep_w: torch.Tensor
    arap_w: torch.Tensor
    depth_sigma: torch.Tensor
    global_w: torch.Tensor  # accepted but unused, as in the reference
    alpha: object = 1.0
    beta: object = 1.0


def _tangent_dim(n: int) -> int:
    return 6 * n + 8


def apply_delta(state: PairState, delta: torch.Tensor) -> PairState:
    n = state.p1.shape[0]
    dp1 = delta[: 3 * n].reshape(n, 3)
    dp2 = delta[3 * n : 6 * n].reshape(n, 3)
    dR, dt = lie.se3_exp(delta[6 * n + 2 : 6 * n + 8])
    Rg, tg = lie.compose(dR, dt, state.Rg, state.tg)
    return PairState(
        p1=state.p1 + dp1,
        p2=state.p2 + dp2,
        s1=state.s1 + delta[6 * n],
        s2=state.s2 + delta[6 * n + 1],
        Rg=Rg,
        tg=tg,
    )


def apply_delta_spec(spec: ModelSpec):
    """Spec-aware retraction: one_set masks the p1 block of the tangent."""
    if not spec.one_set:
        return apply_delta

    def apply(state, delta):
        n = state.p1.shape[0]
        masked = torch.cat([torch.zeros_like(delta[: 3 * n]), delta[3 * n :]])
        return apply_delta(state, masked)

    return apply


# ---------------------------------------------------------------------------
# Edge residuals (weighted so that sum(r^2) equals g2o's chi2)
# ---------------------------------------------------------------------------


def _rep_errors(cam_kind, data: PairData, p, R, t, kp):
    """Unweighted reprojection error e = obs - proj(T p) per point, [N, 2]."""
    return kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))


def _depth_errors(data: PairData, p, s, R, t, d, mode: str = "scaled"):
    """Depth-edge error per point, [N] (``deformable.py:247-279``): "scaled"
    linear (d/s - z), "scaled_squared" the reference's quartic edge, "fixed"
    (d - z s0) and "fixed_squared" with the scale frozen, "none" 0."""
    if mode == "none":
        return torch.zeros_like(d)
    z = lie.apply(R, t, p)[..., 2]
    if mode == "fixed":
        return d - z * s.detach()
    if mode == "fixed_squared":
        return (d - z * s.detach()) ** 2
    if mode == "scaled_squared":
        e = (d / s - z) ** 2
        return torch.where(s <= 0.0, 500.0 * e, e)
    e = d / s - z
    return torch.where(s <= 0.0, math.sqrt(500.0) * e, e)


def _as_tensor(x, like):
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(float(x), dtype=like.dtype, device=like.device)


def _mesh_edge_energy(spec: ModelSpec, p1i, p2i, p1j, p2j, Ri, Rj, w, area, Rg, tg, alpha, beta):
    """Mesh-edge energy of directed edges, batched over the leading dims
    (``_mesh_edge_energy_scalar``, ``deformable.py:282-305``; points [..., 3],
    rotations [..., 3, 3], weights [...])."""

    def mv(M, v):
        return torch.einsum("...ij,...j->...i", M, v)

    def sq(v):
        return torch.sum(v * v, dim=-1)

    d1 = p1i - p1j
    d2 = p2i - p2j
    if spec.energy == "ARAP":
        first = (d2 - mv(Ri, d1)) / area
        second = (-d2 - mv(Rj, -d1)) / area
        e = w * (sq(first) + sq(second))
    elif spec.energy == "Elastic":
        l1 = torch.sqrt(sq(d1) + TINY)
        l2 = torch.sqrt(sq(d2) + TINY)
        e = 2.0 * w * ((l2 - l1) / area) ** 2
    else:  # Ogden
        l1 = torch.sqrt(sq(d1) + TINY)
        l2 = torch.sqrt(sq(d2) + TINY)
        lam = l2 / l1
        alpha = _as_tensor(alpha, l1)
        beta = _as_tensor(beta, l1)
        W = (lam**alpha + lam ** (-alpha * beta) - 2.0) / torch.clamp(alpha, min=1e-6)
        e = w * W * (l1 / area) ** 2
    if spec.use_global:
        g = (mv(Rg, p2i) - tg - p1i) + (mv(Rg, p2j) - tg - p1j)
        e = e + sq(g)
    return e


def _arap_energies(data: PairData, state: PairState, spec: ModelSpec = ModelSpec(), hyper: Hyper = None,
                   src: NeighbourSource = None):
    """Mesh-edge energies per directed edge, [N, K] (masked); ``deformable.py:308-338``."""
    alpha = hyper.alpha if hyper is not None else 1.0
    beta = hyper.beta if hyper is not None else 1.0
    if spec == ModelSpec() or (spec.energy == "ARAP" and spec.use_global and not spec.one_set):
        return arap_ops.arap_edge_energy(
            state.p1, state.p2, data.Ri, data.nbr, data.nbr_mask, data.wcot,
            data.area, state.Rg, state.tg, src=None if src is None else src[:3],
        )
    p1s, p2s, Ris, _ = _neighbours(data, state, src)
    j_safe = torch.clamp(data.nbr, min=0)
    E = _mesh_edge_energy(
        spec, state.p1[:, None, :], state.p2[:, None, :], p1s[j_safe], p2s[j_safe],
        data.Ri[:, None], Ris[j_safe], data.wcot, data.area, state.Rg, state.tg, alpha, beta,
    )
    return torch.where(data.nbr_mask, E, torch.zeros_like(E))


def _huber_rho(chi2, delta=HUBER_DELTA):
    """g2o RobustKernelHuber: rho(s) and rho'(s) on the chi2 scale."""
    d2 = delta * delta
    sqrt_c = torch.sqrt(torch.clamp(chi2, min=TINY))
    inside = chi2 <= d2
    rho = torch.where(inside, chi2, 2.0 * delta * sqrt_c - d2)
    drho = torch.where(inside, torch.ones_like(chi2), delta / sqrt_c)
    return rho, drho


def robust_cost(cam_kind: str, data: PairData, hyper: Hyper, state: PairState, spec: ModelSpec = ModelSpec(),
                src: NeighbourSource = None):
    """Total robustified chi2, the LM accept/reject merit (``deformable.py:350-391``);
    ``src``: see ``NeighbourSource``."""
    with tracing.span("cost"):
        vm = data.valid.to(state.p1.dtype)
        e1 = _rep_errors(cam_kind, data, state.p1, data.R1w, data.t1w, data.kp1)
        e2 = _rep_errors(cam_kind, data, state.p2, data.R2w, data.t2w, data.kp2)
        chi2_1 = torch.sum(e1 * e1, dim=-1) * (data.inv_sigma2_1 * hyper.rep_w)
        chi2_2 = torch.sum(e2 * e2, dim=-1) * (data.inv_sigma2_2 * hyper.rep_w)
        rho1, _ = _huber_rho(chi2_1)
        rho2, _ = _huber_rho(chi2_2)
        cost_rep = torch.sum(vm * (rho1 + rho2))

        info_d = 1.0 / (hyper.depth_sigma * hyper.depth_sigma)
        ed1 = _depth_errors(data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth)
        ed2 = _depth_errors(data, state.p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth)
        cost_depth = torch.sum(vm * info_d * (ed1 * ed1 + ed2 * ed2))

        info_a = hyper.arap_w * data.ntri * data.ntri
        E = _arap_energies(data, state, spec, hyper, src)
        cost = cost_rep + cost_depth + torch.sum(info_a * E * E)

        if spec.depth in ("scaled", "scaled_squared"):
            cost = cost + (
                data.s1_info * (state.s1 - data.s1_prior) ** 2
                + data.s2_info * (state.s2 - data.s2_prior) ** 2
            )
        return cost


def residual_vector(cam_kind: str, data: PairData, hyper: Hyper, state: PairState, spec: ModelSpec = ModelSpec()):
    """Weighted residual vector r with sum(r^2) == robust chi2, Huber IRLS
    weights frozen at ``state`` (``deformable.py:394-447``). Layout:
    [rep1 (2N), rep2 (2N), depth1 (N), depth2 (N), mesh (N*K), sprior (2)]."""
    vm = data.valid.to(state.p1.dtype)

    def rep_block(p, R, t, kp, inv_s2):
        e = kp - cam_ops.project(cam_kind, data.cam_params, lie.apply(R, t, p))
        chi2 = torch.sum(e * e, dim=-1).detach() * inv_s2 * hyper.rep_w
        _, drho = _huber_rho(chi2)
        w = torch.sqrt(drho * inv_s2 * hyper.rep_w) * vm
        return (w[:, None] * e).reshape(-1)

    r_rep1 = rep_block(state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1)
    r_rep2 = rep_block(state.p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2)

    inv_sigma_d = 1.0 / hyper.depth_sigma
    rd1 = vm * inv_sigma_d * _depth_errors(data, state.p1, state.s1, data.R1w, data.t1w, data.depth1, spec.depth)
    rd2 = vm * inv_sigma_d * _depth_errors(data, state.p2, state.s2, data.R2w, data.t2w, data.depth2, spec.depth)

    j_safe = torch.clamp(data.nbr, min=0)
    edge_ok = (data.nbr_mask & data.valid[:, None] & data.valid[j_safe]).to(state.p1.dtype)
    sqrt_info_a = torch.sqrt(hyper.arap_w) * data.ntri
    r_arap = (edge_ok * sqrt_info_a * _arap_energies(data, state, spec, hyper)).reshape(-1)

    sgate = 1.0 if spec.depth in ("scaled", "scaled_squared") else 0.0
    r_sprior = torch.stack(
        [
            sgate * torch.sqrt(data.s1_info) * (state.s1 - data.s1_prior),
            sgate * torch.sqrt(data.s2_info) * (state.s2 - data.s2_prior),
        ]
    )
    return torch.cat([r_rep1, r_rep2, rd1, rd2, r_arap, r_sprior])


# ---------------------------------------------------------------------------
# Normal-equation assembly from per-edge local Jacobians
# ---------------------------------------------------------------------------


def _mesh_slot_jacobian(data: PairData, hyper: Hyper, state: PairState, spec: ModelSpec = ModelSpec(),
                        src: NeighbourSource = None):
    """Weighted energy r [N*K] of every directed mesh-edge slot and its
    Jacobian L [N*K, 18] over (p1_i, p2_i, p1_j, p2_j, xi), by forward-mode
    AD of the batched edge energy; masked slots carry exact zeros."""
    n, K = data.nbr.shape
    dtype, dev = state.p1.dtype, state.p1.device
    p1s, p2s, Ris, valids = _neighbours(data, state, src)
    j_safe = torch.clamp(data.nbr, min=0)
    sqrt_info_a = torch.sqrt(hyper.arap_w) * data.ntri
    w_edge = (data.nbr_mask & data.valid[:, None] & valids[j_safe]).to(dtype) * sqrt_info_a

    Rg0, tg0 = state.Rg, state.tg
    ii = torch.arange(n, device=dev)[:, None].expand(n, K).reshape(-1)
    jj = j_safe.reshape(-1)
    Ri_e, Rj_e = data.Ri[ii], Ris[jj]
    wcot_e, we = data.wcot.reshape(-1), w_edge.reshape(-1)

    def local(x):  # x [NK, 18] -> [NK] weighted edge energies
        dR, dt = lie.se3_exp(x[:, 12:18])
        Rg, tg = lie.compose(dR, dt, Rg0, tg0)
        energy = _mesh_edge_energy(
            spec, x[:, 0:3], x[:, 3:6], x[:, 6:9], x[:, 9:12], Ri_e, Rj_e, wcot_e, data.area,
            Rg, tg, hyper.alpha, hyper.beta,
        )
        return we * energy

    x_edges = torch.cat(
        [state.p1[ii], state.p2[ii], p1s[jj], p2s[jj], torch.zeros((n * K, 6), dtype=dtype, device=dev)],
        dim=-1,
    )
    # One forward-mode JVP per local coordinate, vmapped over the 18
    # coordinates (each edge's energy depends only on its own row of
    # x_edges, so the JVP along e_k is column k of every row's Jacobian).
    basis = torch.eye(18, dtype=dtype, device=dev)[:, None, :].expand(18, n * K, 18)
    L = vmap(lambda v: jvp(local, (x_edges,), (v,))[1])(basis).T
    return L, local(x_edges)


def _edge_blocks(cam_kind: str, data: PairData, hyper: Hyper, state: PairState, spec: ModelSpec = ModelSpec()):
    """Per-edge local Jacobians for every edge family (``deformable.py:468-629``).

    Returns a list of (L [M, rdim, d], r [M, rdim], idx [M, d]) triples;
    padded/invalid edges carry zero weights so their blocks vanish.
    """
    n = state.p1.shape[0]
    dtype, dev = state.p1.dtype, state.p1.device
    blocks = []

    vm = data.valid.to(dtype)
    ar = torch.arange(n, device=dev)
    idx_p1 = 3 * ar[:, None] + torch.arange(3, device=dev)[None, :]
    idx_p2 = 3 * n + idx_p1
    i_s1 = 6 * n
    i_s2 = 6 * n + 1
    idx_xi = 6 * n + 2 + torch.arange(6, device=dev)

    def rep_weights(e, inv_sigma2):
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2 * hyper.rep_w
        _, drho = _huber_rho(chi2)
        return torch.sqrt(drho * inv_sigma2 * hyper.rep_w) * vm

    # Reprojection edges: closed-form de/dp = -(dproj/dpc) R.
    for (p, R, t, kp, inv_s2, idx_p) in (
        (state.p1, data.R1w, data.t1w, data.kp1, data.inv_sigma2_1, idx_p1),
        (state.p2, data.R2w, data.t2w, data.kp2, data.inv_sigma2_2, idx_p2),
    ):
        pc = lie.apply(R, t, p)
        e = kp - cam_ops.project(cam_kind, data.cam_params, pc)
        w = rep_weights(e, inv_s2)
        Jpi = cam_ops.project_jac(cam_kind, data.cam_params, pc)
        L = -w[:, None, None] * torch.einsum("nab,bc->nac", Jpi, R)
        blocks.append((L, w[:, None] * e, idx_p))

    # Depth edges: closed-form residual/Jacobian through z = (R p + t)[2].
    if spec.depth != "none":
        inv_sigma_d = 1.0 / hyper.depth_sigma
        for (p, s, R, t, d, idx_p, i_s) in (
            (state.p1, state.s1, data.R1w, data.t1w, data.depth1, idx_p1, i_s1),
            (state.p2, state.s2, data.R2w, data.t2w, data.depth2, idx_p2, i_s2),
        ):
            w = vm * inv_sigma_d
            z = (p @ R.T + t)[:, 2]
            if spec.depth == "fixed":
                e = d - z * s
                de_dz = torch.full_like(e, 1.0) * (-s)
                de_ds = torch.zeros_like(e)
            elif spec.depth == "fixed_squared":
                u_ = d - z * s
                e = u_ * u_
                de_dz = -2.0 * u_ * s
                de_ds = torch.zeros_like(e)
            elif spec.depth == "scaled_squared":
                u_ = d / s - z
                pen = torch.where(s <= 0.0, 500.0, 1.0).to(dtype)
                e = pen * u_ * u_
                de_dz = pen * (-2.0 * u_)
                de_ds = pen * (-2.0 * u_ * d / (s * s))
            else:
                pen = torch.where(s <= 0.0, math.sqrt(500.0), 1.0).to(dtype)
                e = pen * (d / s - z)
                de_dz = torch.ones_like(e) * (-pen)
                de_ds = pen * (-d / (s * s))
            L = torch.cat(
                [(w * de_dz)[:, None] * R[2, :][None, :], (w * de_ds)[:, None]], dim=-1
            )[:, None, :]
            idx = torch.cat([idx_p, torch.full((n, 1), i_s, dtype=idx_p.dtype, device=dev)], dim=-1)
            blocks.append((L, (w * e)[:, None], idx))

    # Mesh edges (flattened [N*K]): local Jacobian over the 18 coordinates
    # each edge touches (p1_i, p2_i, p1_j, p2_j, xi).
    K = data.nbr.shape[1]
    ii = ar[:, None].expand(n, K).reshape(-1)
    jj = torch.clamp(data.nbr, min=0).reshape(-1)
    L, r = _mesh_slot_jacobian(data, hyper, state, spec)
    idx = torch.cat([idx_p1[ii], idx_p2[ii], idx_p1[jj], idx_p2[jj], idx_xi.expand(n * K, 6)], dim=-1)
    blocks.append((L[:, None, :], r[:, None], idx))

    # Depth-scale prior edges (unit edges on s1, s2).
    if spec.depth in ("scaled", "scaled_squared"):
        sqrt_i = torch.stack([torch.sqrt(data.s1_info), torch.sqrt(data.s2_info)]).to(dtype)
        r_s = (sqrt_i * torch.stack([state.s1 - data.s1_prior, state.s2 - data.s2_prior]).to(dtype)).reshape(2, 1)
        idx_s = (i_s1 + torch.arange(2, dtype=idx_p1.dtype, device=dev))[:, None]  # [[i_s1], [i_s2]]
        blocks.append((sqrt_i.reshape(2, 1, 1), r_s, idx_s))

    if spec.one_set:
        # Frozen first set: zero every local-Jacobian entry on a p1 coordinate.
        blocks = [(L * (idx[:, None, :] >= 3 * n).to(L.dtype), r, idx) for L, r, idx in blocks]
    return blocks


def build_system_jacfwd(cam_kind: str, data: PairData, hyper: Hyper, state: PairState, spec: ModelSpec = ModelSpec()):
    """Gauss-Newton (H, g) from the [dim]-wide forward Jacobian of the full
    residual vector (``deformable.py:632-660``); the path one-set models take."""
    dim = _tangent_dim(state.p1.shape[0])
    apply = apply_delta_spec(spec)

    def f(delta):
        r = residual_vector(cam_kind, data, hyper, apply(state, delta), spec)
        return r, r

    zero = torch.zeros((dim,), dtype=state.p1.dtype, device=state.p1.device)
    J, r = jacfwd(f, has_aux=True)(zero)  # [R, dim], [R]
    return J.T @ J, J.T @ r


def build_system(cam_kind: str, data: PairData, hyper: Hyper, state: PairState, spec: ModelSpec = ModelSpec()):
    """Gauss-Newton H, g at ``state`` with robust weights frozen there
    (``deformable.py:663-714``): the local blocks are scattered row-wise into
    a dense J, then H = J^T J and g = J^T r.

    INVARIANT (scatter-set correctness, ``deformable.py:694-701``): masked
    mesh-edge rows carry identically-zero local Jacobians. A padded neighbour
    is clamped to point 0, so such a row may name one column twice; with
    scatter-set semantics (which on CUDA pick an arbitrary writer among
    duplicates) only exact zeros make that deterministic.
    """
    with tracing.span("assembly"):
        if spec.one_set:
            return build_system_jacfwd(cam_kind, data, hyper, state, spec)
        dim = _tangent_dim(state.p1.shape[0])
        blocks = _edge_blocks(cam_kind, data, hyper, state, spec)
        rows = sum(L.shape[0] * L.shape[1] for L, _, _ in blocks)
        J = torch.zeros((rows, dim), dtype=state.p1.dtype, device=state.p1.device)
        rs = []
        off = 0
        for L, r_, idx in blocks:
            M, rr, dd = L.shape
            cols = idx[:, None, :].expand(M, rr, dd).reshape(M * rr, dd)
            J[off : off + M * rr].scatter_(1, cols, L.reshape(M * rr, dd))
            rs.append(r_.reshape(-1))
            off += M * rr
        r = torch.cat(rs)
        return J.T @ J, J.T @ r


def assemble_diag(cam_kind: str, data: PairData, hyper: Hyper, state: PairState, spec: ModelSpec = ModelSpec()):
    """diag(J^T J) from the per-edge blocks, no H built (``deformable.py:717-737``).

    JAX scatter-adds every edge's squared column norms with ``.at[].add``.
    Here the contributions are stably sorted by index and each index's run
    summed by ``torch.segment_reduce``, so duplicates add in one fixed order
    on either device (a scatter-add on the card sums in a varying order) and
    two calls give the same bits."""
    dim = _tangent_dim(state.p1.shape[0])
    blocks = _edge_blocks(cam_kind, data, hyper, state, spec)
    idx = torch.cat([i.reshape(-1) for _, _, i in blocks])
    contrib = torch.cat([torch.einsum("mri,mri->mi", L, L).reshape(-1) for L, _, _ in blocks])
    order = torch.argsort(idx, stable=True)
    lengths = torch.bincount(idx, minlength=dim)
    return torch.segment_reduce(contrib[order], "sum", lengths=lengths, unsafe=True, initial=0.0)


# ---------------------------------------------------------------------------
# Solve entry point
# ---------------------------------------------------------------------------

# Above this tangent dimension the dense normal equations are not
# materialized and the block-sparse PCG backend takes over
# (``deformable.py:744-750``); the reference's own problem, dim 5174, lands
# there.
DENSE_DIM_LIMIT = 4096

# PCG iteration cap and relative tolerance of the block backend
# (``deformable.py:752-756``).
CG_ITERS = 64
CG_RTOL = 1e-2

# Dense-backend Jacobian budget across a batch of pairs
# (``deformable.py:758-763``): the dense path holds J [N (6 + K) + 2, dim]
# per pair, and ``solve_pairs`` multiplies that by the batch. The JAX
# package sized it for a 16 GB TPU. It is kept as it is, so that
# ``use_dense_backend`` picks JAX's backend for every (n, K, batch) and the
# parity tests compare like with like; re-deriving it for an 80 GB card from
# the measured peak of a dense serving step is a ROADMAP item.
DENSE_J_BUDGET_BYTES = 2 << 30


def use_dense_backend(n: int, K: int, batch: int = 1) -> bool:
    """Backend dispatch (``deformable.py:766-777``): dense while the tangent
    dim is within ``DENSE_DIM_LIMIT`` and the batch-wide Jacobian within
    ``DENSE_J_BUDGET_BYTES``, block PCG otherwise."""
    dim = _tangent_dim(n)
    if dim > DENSE_DIM_LIMIT:
        return False
    rows = n * (6 + K) + 2
    return batch * rows * dim * 4 <= DENSE_J_BUDGET_BYTES


def solve_pair(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state0: PairState,
    n_iterations: int,
    spec: ModelSpec = ModelSpec(),
) -> lm_ops.LMResult:
    """One ``arapOptimization`` inner solve: n_iterations of LM
    (``deformable.py:783-823``), dense equilibrated Cholesky or, above the
    dense limits, block-sparse assembly with block-Jacobi PCG."""
    from . import block_system

    n = state0.p1.shape[0]
    cost = lambda s: robust_cost(cam_kind, data, hyper, s, spec)
    if not use_dense_backend(n, int(data.nbr.shape[-1])):
        return lm_ops.lm_optimize_general(
            block_system.make_block_step(cam_kind, data, hyper, spec, CG_ITERS, CG_RTOL),
            robust_cost=cost,
            apply_delta=apply_delta_spec(spec),
            state0=state0,
            n_iterations=n_iterations,
        )
    return lm_ops.lm_optimize(
        build_system=lambda s: build_system(cam_kind, data, hyper, s, spec),
        robust_cost=cost,
        apply_delta=apply_delta_spec(spec),
        state0=state0,
        n_iterations=n_iterations,
    )


def _hyper_members(hyper: Hyper, batch: int) -> list:
    """One Hyper per pair: a shared Hyper (0-d fields) for every pair, or
    the members of a batched one (leading pair axis; a field that is not a
    tensor with that axis is shared), as ``hyper_axis`` does in JAX."""
    if torch.as_tensor(hyper.rep_w).ndim == 0:
        return [hyper] * batch
    fields = [f.unbind(0) if isinstance(f, torch.Tensor) and f.ndim > 0 else [f] * batch for f in hyper]
    return [Hyper(*col) for col in zip(*fields)]


def solve_pairs(
    cam_kind: str,
    data: PairData,
    hyper: Hyper,
    state0: PairState,
    n_iterations: int,
    spec: ModelSpec = ModelSpec(),
    backend_batch: int | None = None,
) -> lm_ops.LMResult:
    """Batched multi-pair refinement (``deformable.py:826-917``): every field
    of ``data`` and ``state0`` carries a leading pair axis, ``hyper`` is
    shared (0-d fields) or batched. The pairs share (N, K).

    The batch runs under ``lm_optimize_flat_batched``: one global step
    linearizes every pair, makes one batched solve and one batched cost,
    and each pair keeps its own sequential (lambda, nu, accept) schedule.
    The backend follows ``use_dense_backend(n, K, batch)``, as in JAX, with
    ``batch`` the whole batch's size: ``backend_batch`` where the pairs are a
    rank's slice of a pair-sharded batch (``parallel/dist.solve_pairs_sharded``),
    else this batch's:

    - dense: each pair's (H, g) from ``build_system``, ``diag_max`` per
      pair, and ONE launch of kernel 1's batched entry for the batch
      (``ops/lm.solve_damped_cholesky_batched``; JAX vmaps the contract);
    - block: each pair's ``build_block_system``, and kernel 2 once per pair
      (``ops/block_pcg.pcg_block_system``, B launches a step; JAX vmaps the
      plain ``pcg_flex`` there).

    Assembly and cost run pair by pair in a Python loop (the dense build
    writes J with an in-place ``scatter_``), so each pair's arithmetic is
    its ``solve_pair`` arithmetic. Returns LMResult with per-pair ``cost``,
    ``lam`` and ``n_accepted`` ([B]) and the global steps in ``n_solves``.
    """
    from ..ops import block_pcg
    from . import block_system

    batch = int(data.kp1.shape[0])
    n = int(state0.p1.shape[1])
    K = int(data.nbr.shape[-1])
    datas = lm_ops.unstack(data)
    hypers = _hyper_members(hyper, batch)

    def cost_b(state_b):
        return torch.stack([robust_cost(cam_kind, d, h, s, spec)
                            for d, h, s in zip(datas, hypers, lm_ops.unstack(state_b))])

    if use_dense_backend(n, K, batch if backend_batch is None else backend_batch):

        def make_step_b(state_b):
            Hg = [build_system(cam_kind, d, h, s, spec) for d, h, s in zip(datas, hypers, lm_ops.unstack(state_b))]
            H = torch.stack([h for h, _ in Hg])
            g = torch.stack([gg for _, gg in Hg])
            diag_max = torch.stack([torch.max(torch.diagonal(h)) for h, _ in Hg])
            return (lambda lam_b: lm_ops.solve_damped_cholesky_batched(H, g, lam_b)), g, diag_max

    else:

        def make_step_b(state_b):
            systems = [block_system.build_block_system(cam_kind, d, h, s, spec)
                       for d, h, s in zip(datas, hypers, lm_ops.unstack(state_b))]
            g = torch.stack([block_system.flat_gradient(sy) for sy in systems])
            diag_max = torch.stack([torch.max(block_system.diag_of(sy)) for sy in systems])

            def solve_b(lam_b):
                return torch.stack([
                    block_pcg.pcg_block_system(sy, d.nbr, -gg, lam, CG_ITERS, CG_RTOL)
                    for sy, d, gg, lam in zip(systems, datas, g, lam_b)
                ])

            return solve_b, g, diag_max

    return lm_ops.lm_optimize_flat_batched(
        make_step_b, cost_b, apply_delta_spec(spec), state0, batch, n_iterations,
    )


def solve_pairs_pipelined(
    cam_kind: str,
    datas,
    hyper: Hyper,
    states,
    n_iterations: int,
    spec: ModelSpec = ModelSpec(),
) -> list:
    """The per-pair serving scheduler (``deformable.py:920-961``): one
    ``solve_pair`` per pair, in order; returns their LMResults.

    In JAX the solves are queued back to back and the caller syncs once.
    Here every LM trial reads its accept decision back to the host, so one
    pair's solve does not overlap the next one's on the device; the port
    adds no streams. The JAX docstring's TPU rates are not the port's.
    """
    return [solve_pair(cam_kind, d, hyper, s, n_iterations, spec) for d, s in zip(datas, states)]


def make_pair_data(
    kp1,
    kp2,
    depth1,
    depth2,
    valid,
    cam_params,
    T1w,
    T2w,
    p1,
    p2,
    inv_sigma2_1=None,
    inv_sigma2_2=None,
    mesh_backend: str = "auto",
    degree_bucket: int = 32,
    scale_priors=None,
    device="cuda",
):
    """Host-side assembly (``deformable.py:964-1042``): mesh the current p1
    cloud (valid points only), cot weights, and the per-vertex ARAP
    rotations computed on ``device`` in f32. ``T1w``/``T2w`` are (R, t)
    pairs of tensors or arrays."""
    dev = torch.device(device)
    n = len(kp1)
    valid_np = np.asarray(valid, dtype=bool)
    p1_np = np.asarray(p1, dtype=np.float64)
    p2_np = np.asarray(p2, dtype=np.float64)

    vidx = np.nonzero(valid_np)[0]
    ctx = mesh_ops.build_mesh_context(p1_np[vidx], backend=mesh_backend, degree_multiple=degree_bucket)
    K = ctx.max_degree
    nbr = np.full((n, K), -1, dtype=np.int64)
    wcot = np.zeros((n, K), dtype=np.float64)
    remap = vidx.astype(np.int64)
    nbr[vidx] = np.where(ctx.nbr >= 0, remap[np.maximum(ctx.nbr, 0)], -1)
    wcot[vidx] = ctx.weights

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=FP)
        return torch.as_tensor(np.asarray(x), dtype=FP, device=dev)

    nbr_t = torch.as_tensor(nbr, device=dev)
    mask = nbr_t >= 0
    wcot_t = t(wcot)
    R = arap_ops.compute_rotations(t(p1_np), t(p2_np), nbr_t, mask, wcot_t)

    ones = np.ones(n)
    sp = (0.0, 0.0, 0.0, 0.0) if scale_priors is None else tuple(float(v) for v in scale_priors)
    return PairData(
        kp1=t(kp1),
        kp2=t(kp2),
        inv_sigma2_1=t(ones if inv_sigma2_1 is None else inv_sigma2_1),
        inv_sigma2_2=t(ones if inv_sigma2_2 is None else inv_sigma2_2),
        depth1=t(depth1),
        depth2=t(depth2),
        valid=torch.as_tensor(valid_np, device=dev),
        cam_params=t(cam_params),
        R1w=t(T1w[0]),
        t1w=t(T1w[1]),
        R2w=t(T2w[0]),
        t2w=t(T2w[1]),
        nbr=nbr_t,
        nbr_mask=mask,
        wcot=wcot_t,
        Ri=R,
        area=t(ctx.surface_area),
        ntri=t(float(ctx.n_triangles)),
        s1_prior=t(sp[0]),
        s1_info=t(sp[1]),
        s2_prior=t(sp[2]),
        s2_info=t(sp[3]),
    )
