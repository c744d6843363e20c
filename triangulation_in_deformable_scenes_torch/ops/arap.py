"""ARAP kernels: per-vertex rotations and edge energies.

Counterpart of ``triangulation_in_deformable_scenes_tpu/ops/arap.py:31-171``
(``compute_rotations`` == the reference's ``computeR``,
``arap_edge_energy`` == ``EdgeARAP::computeError``, ``arap_deform`` == the
local-global deformation of the open3DArap selection). Padded neighbor slots
(-1) gather row 0 and are masked downstream.
"""

from __future__ import annotations

import torch

from . import lie


def _gather_nbr(p, nbr):
    """p[N, 3], nbr[N, K] -> p[nbr][N, K, 3] with pad-safe indices."""
    return p[torch.clamp(nbr, min=0)]


def compute_rotations(p1, p2, nbr, nbr_mask, weights):
    """Batched ``computeR`` (``arap.py:37-55``): best-fit rotation of each
    vertex's p1 neighbourhood onto p2; vertices without neighbours keep I."""
    p1j = _gather_nbr(p1, nbr)
    p2j = _gather_nbr(p2, nbr)
    e1 = p1[:, None, :] - p1j
    e2 = p2[:, None, :] - p2j
    w = torch.where(nbr_mask, weights, torch.zeros_like(weights))
    S = torch.einsum("nk,nki,nkj->nij", w, e1, e2)
    R = lie.fit_rotation(S)
    has_nbr = torch.any(nbr_mask, dim=-1)
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device).expand(R.shape)
    return torch.where(has_nbr[:, None, None], R, eye)


def arap_edge_energy(p1, p2, R, nbr, nbr_mask, weights, area, Rg, tg, src=None):
    """Energy of every directed mesh edge; [N, K] with zeros on padding
    (``arap.py:58-87``). ``src`` = (p1, p2, R) that ``nbr`` indexes, when it
    is not the rows themselves (a landmark shard's rows read the whole
    pair's arrays)."""
    p1s, p2s, Rs = (p1, p2, R) if src is None else src
    p1j = _gather_nbr(p1s, nbr)
    p2j = _gather_nbr(p2s, nbr)
    Rj = Rs[torch.clamp(nbr, min=0)]

    d1i = p1[:, None, :] - p1j
    d2i = p2[:, None, :] - p2j

    Ri_d1i = torch.einsum("nab,nkb->nka", R, d1i)
    Rj_d1j = torch.einsum("nkab,nkb->nka", Rj, -d1i)

    first = (d2i - Ri_d1i) / area
    second = (-d2i - Rj_d1j) / area

    g_i = torch.einsum("ab,nb->na", Rg, p2) - tg - p1
    g_j = torch.einsum("ab,nkb->nka", Rg, p2j) - tg - p1j
    diff_global = g_i[:, None, :] + g_j
    energy_global = torch.sum(diff_global * diff_global, dim=-1)

    energy = (
        weights * (torch.sum(first * first, dim=-1) + torch.sum(second * second, dim=-1))
        + energy_global
    )
    return torch.where(nbr_mask, energy, torch.zeros_like(energy))


def arap_deform(p_rest, nbr, nbr_mask, weights, constraint_idx, constraint_pos, iters: int = 50, p_init=None):
    """Local-global ARAP surface deformation (Sorkine-Alexa) for the
    open3DArap selection (``arap.py:90-147``): the weighted graph Laplacian
    (L[i, i] = sum_j w_ij, L[i, j] = -w_ij) with identity rows at the
    constraints and a 1e-12 ridge, LU-factorised once and reused by each of
    ``iters`` steps of per-vertex rotation fit and linear solve. The
    Laplacian's LU is ``torch.linalg.lu_factor`` / ``lu_solve`` on both
    devices (JAX's is ``jax.scipy.linalg``, outside any Pallas kernel)."""
    n = p_rest.shape[0]
    dtype, dev = p_rest.dtype, p_rest.device
    w = torch.where(nbr_mask, weights, torch.zeros_like(weights))
    j_safe = torch.clamp(nbr, min=0)
    eye = torch.eye(n, dtype=dtype, device=dev)
    ar = torch.arange(n, device=dev)

    L = torch.zeros((n, n), dtype=dtype, device=dev)
    L.index_put_((ar[:, None].expand_as(nbr), j_safe), -w, accumulate=True)
    L[ar, ar] += w.sum(1)
    cmask = torch.zeros(n, dtype=torch.bool, device=dev)
    cmask[constraint_idx] = True
    L = torch.where(cmask[:, None], eye, L) + 1e-12 * eye
    lu, piv = torch.linalg.lu_factor(L)

    cpos = torch.zeros((n, 3), dtype=dtype, device=dev)
    cpos[constraint_idx] = constraint_pos
    p = p_rest if p_init is None else p_init
    rest_edges = p_rest[:, None, :] - p_rest[j_safe]
    for _ in range(iters):
        R = compute_rotations(p_rest, p, nbr, nbr_mask, weights)
        rhs_edges = 0.5 * torch.einsum("nk,nkab,nkb->na", w, R[:, None] + R[j_safe], rest_edges)
        p = torch.linalg.lu_solve(lu, piv, torch.where(cmask[:, None], cpos, rhs_edges))
    return p


def relative_edge_errors(p1, p2, nbr, nbr_mask):
    """Per directed edge ||(p2_i - p2_j) - (p1_i - p1_j)||^2 (``arap.py:150-161``)."""
    p1j = _gather_nbr(p1, nbr)
    p2j = _gather_nbr(p2, nbr)
    diff = (p2[:, None, :] - p2j) - (p1[:, None, :] - p1j)
    e = torch.sum(diff * diff, dim=-1)
    return torch.where(nbr_mask, e, torch.zeros_like(e))


def global_edge_errors(p1, p2, nbr, nbr_mask, Rg, tg):
    """Per directed edge global-alignment error (``arap.py:164-171``)."""
    p1j = _gather_nbr(p1, nbr)
    p2j = _gather_nbr(p2, nbr)
    g_i = torch.einsum("ab,nb->na", Rg, p2) - tg - p1
    g_j = torch.einsum("ab,nkb->nka", Rg, p2j) - tg - p1j
    diff = g_i[:, None, :] + g_j
    e = torch.sum(diff * diff, dim=-1)
    return torch.where(nbr_mask, e, torch.zeros_like(e))
