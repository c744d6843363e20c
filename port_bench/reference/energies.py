"""Plain reference of the mesh energies other than ARAP: the one-term Ogden
hyperelastic energy (the model ``HyperElasticOdgen``).

The reference C++ ships only the ARAP edge. This energy is the JAX
package's reconstruction of it, from the reference's committed
``Data/Experiments/HyperElasticOdgen`` results and the (alpha, beta) that
its ARAP edge carries, written out here from the formula alone. For a
directed mesh edge (i, j) with edge vectors d1 = p1_i - p1_j, d2 = p2_i -
p2_j, lengths l1 = sqrt(|d1|^2 + TINY), l2 = sqrt(|d2|^2 + TINY) and stretch
lambda = l2 / l1:

    W(lambda) = (lambda^alpha + lambda^(-alpha beta) - 2) / max(alpha, 1e-6)
    e = w_cot W(lambda) (l1 / area)^2 + |g|^2,

with the global-alignment term g = (Rg p2_i - tg - p1_i) + (Rg p2_j - tg -
p1_j) as in ARAP's edge. The edge's residual is sqrt(arap weight) ntri e,
as for ARAP.

The slot Jacobian (``slot_jacobian``) is derived by hand, not by automatic
differentiation: dW/dlambda, then lambda, l1 and l2 through the edge
vectors, plus the global term's derivative at xi = 0, so that it stays
independent of the program's forward-mode path.

``run_condition`` is ``pipeline.run_condition`` with this energy put
wherever the reference uses ARAP's (the cost, the dense Gauss-Newton
system, the search's tie-break and its reference energy); observations,
triangulation, mesh, frozen rotations, LM, damped Cholesky, Huber, depth
errors and the rigid selection are the ARAP reference's own, by import.
Dense backend only: a problem whose tangent dim exceeds
``solver.DENSE_DIM_LIMIT`` (4096) raises, since the reference's block
system holds ARAP's closed form. Plain PyTorch; imports nothing of the
program or of JAX.
"""

from __future__ import annotations

import contextlib

import torch

from . import pipeline as P
from . import solver as S

MODEL = "HyperElasticOdgen"


def _pq(lam, alpha, beta):
    """(lambda^alpha, lambda^(-alpha beta), max(alpha, 1e-6))."""
    return torch.pow(lam, alpha), torch.pow(lam, -alpha * beta), max(alpha, 1e-6)


def _global_term(p1i, p2i, p1j, p2j, Rg, tg):
    ai = torch.einsum("...ab,...b->...a", Rg, p2i) - tg
    aj = torch.einsum("...ab,...b->...a", Rg, p2j) - tg
    return ai, aj, ai + aj - p1i - p1j


def edge_energy(p1i, p2i, p1j, p2j, w, area, Rg, tg, alpha: float, beta: float):
    """Ogden energy with the global term of directed edges, batched over the
    leading dims (points [..., 3], weights [...])."""
    d1 = p1i - p1j
    d2 = p2i - p2j
    l1 = torch.sqrt(torch.sum(d1 * d1, dim=-1) + S.TINY)
    l2 = torch.sqrt(torch.sum(d2 * d2, dim=-1) + S.TINY)
    p, q, a = _pq(l2 / l1, alpha, beta)
    _, _, g = _global_term(p1i, p2i, p1j, p2j, Rg, tg)
    return w * ((p + q - 2.0) / a) * (l1 / area) ** 2 + torch.sum(g * g, dim=-1)


def edge_energies(data: S.PairData, state: S.PairState, alpha: float, beta: float):
    """Energy of every directed mesh edge [N, K], zeros on padding."""
    j = torch.clamp(data.nbr, min=0)
    e = edge_energy(state.p1[:, None, :], state.p2[:, None, :], state.p1[j], state.p2[j], data.wcot, data.area,
                    state.Rg, state.tg, alpha, beta)
    return torch.where(data.nbr_mask, e, torch.zeros_like(e))


def slot_jacobian(data: S.PairData, hyper: S.Hyper, state: S.PairState, alpha: float, beta: float):
    """Weighted slot energies r [N*K] and their Jacobians L [N*K, 18] over
    (p1_i, p2_i, p1_j, p2_j, xi = (omega, upsilon)), in closed form:

    - with c = w_cot / area^2, de/dl1 = c (2 l1 W - l2 W') and de/dl2 =
      c l1 W', so de/dp1_i = c (2 W - lambda W') d1 and de/dp2_i =
      c (lambda W') d2 / lambda^2, where lambda W' = (alpha lambda^alpha -
      alpha beta lambda^(-alpha beta)) / max(alpha, 1e-6); the j ends take
      the opposite signs;
    - the global term adds -2 g to both p1 ends, 2 Rg^T g to both p2 ends,
      2 (a_i + a_j) x g on omega and -4 g on upsilon (a = Rg p2 - tg).
    """
    n, K = data.nbr.shape
    dtype = state.p1.dtype
    j = torch.clamp(data.nbr, min=0)
    w_edge = ((data.nbr_mask & data.valid[:, None] & data.valid[j]).to(dtype)
              * torch.sqrt(hyper.arap_w) * data.ntri)
    p1i = state.p1[:, None, :].expand(n, K, 3)
    p2i = state.p2[:, None, :].expand(n, K, 3)
    p1j, p2j = state.p1[j], state.p2[j]
    d1 = p1i - p1j
    d2 = p2i - p2j
    l1 = torch.sqrt(torch.sum(d1 * d1, dim=-1) + S.TINY)
    l2 = torch.sqrt(torch.sum(d2 * d2, dim=-1) + S.TINY)
    lam = l2 / l1
    p, q, a = _pq(lam, alpha, beta)
    W = (p + q - 2.0) / a
    lam_dW = (alpha * p - alpha * beta * q) / a
    c = data.wcot.to(dtype) / (data.area * data.area)
    j1 = (c * (2.0 * W - lam_dW))[..., None] * d1
    j2 = (c * lam_dW / (lam * lam))[..., None] * d2
    ai, aj, g = _global_term(p1i, p2i, p1j, p2j, state.Rg, state.tg)
    rg = 2.0 * (g @ state.Rg)
    e = c * W * l1 * l1 + torch.sum(g * g, dim=-1)
    L = torch.cat([j1 - 2.0 * g, j2 + rg, -j1 - 2.0 * g, -j2 + rg, 2.0 * torch.linalg.cross(ai + aj, g), -4.0 * g],
                  dim=-1) * w_edge[..., None]
    return L.reshape(n * K, 18), (w_edge * e).reshape(n * K)


@contextlib.contextmanager
def energy_of(cfg: dict):
    """The reference with the configuration's mesh energy put wherever it
    uses ARAP's: ``solver.arap_energies`` (cost, tie-break, the search's
    reference energy) and ``solver._mesh_slot_jacobian`` (the dense
    system). Restored on exit."""
    if cfg["model"] != MODEL:
        raise ValueError(f"no reference energy for model {cfg['model']!r}")
    alpha, beta = float(cfg["alpha"]), float(cfg["beta"])
    saved = S.arap_energies, S._mesh_slot_jacobian
    S.arap_energies = lambda data, state: edge_energies(data, state, alpha, beta)
    S._mesh_slot_jacobian = lambda data, hyper, state: slot_jacobian(data, hyper, state, alpha, beta)
    try:
        yield
    finally:
        S.arap_energies, S._mesh_slot_jacobian = saved


def _dense_only(n: int):
    if S.tangent_dim(n) > S.DENSE_DIM_LIMIT:
        raise ValueError(f"tangent dim {S.tangent_dim(n)} above {S.DENSE_DIM_LIMIT}: the energy reference is dense only")


def robust_cost(cfg: dict, data: S.PairData, hyper: S.Hyper, state: S.PairState):
    with energy_of(cfg):
        return S.robust_cost(data, hyper, state)


def build_system(cfg: dict, data: S.PairData, hyper: S.Hyper, state: S.PairState):
    """Dense (H, g) = (J^T J, J^T r), Huber weights frozen at ``state``."""
    _dense_only(state.p1.shape[0])
    with energy_of(cfg):
        return S.build_system(data, hyper, state)


def solve_pair(cfg: dict, data: S.PairData, hyper: S.Hyper, state0: S.PairState, n_iterations: int) -> S.LMResult:
    _dense_only(state0.p1.shape[0])
    with energy_of(cfg):
        return S.solve_pair(data, hyper, state0, n_iterations)


def run_condition(cfg: dict, c2_pose, orig, moved, noise_seed: int, device) -> P.ConditionResult:
    """``pipeline.run_condition`` under the configuration's energy."""
    _dense_only(len(orig))
    with energy_of(cfg):
        return P.run_condition(cfg, c2_pose, orig, moved, noise_seed, device)
