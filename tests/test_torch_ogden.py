"""The port's one-term Ogden energy (``HyperElasticOdgen``) against the
benchmark's plain reference (``port_bench/reference/energies.py``), on the
CPU, on seeded random sweep conditions at 40 points.

Both sides read one pair's data: the reference's own first problem of the
condition (observations, triangulation, mesh, frozen rotations), handed to
the port field by field, so that the two meet the same neighbour slots.

Tolerances, each with its reason:

- edge energies, robust cost, dense (H, g) and the block system in
  float64: 1e-9 relative to the largest entry. The two sides evaluate the
  same formula in a different order (the port's Jacobian by forward-mode AD,
  the reference's in closed form), so only float64 rounding separates them
  (measured <= 1e-15);
- the reference's closed-form slot Jacobian against ``torch.autograd`` of
  its own edge energy in float64: 1e-9 of the largest entry, for the same
  reason;
- one short ``solve_pair`` (6 iterations) in float64: the same trials, points
  within 1e-9 m and cost within 1e-9 relative (measured <= 1e-13 m);
- the same in float32: the same accepted iterations and points within
  1e-4 m. The port's Jacobian comes from forward-mode AD and the reference's
  from the closed form, so H differs by float32 rounding, and on these stiff
  first steps (the cost falls from about 1e10 by 10x an iteration) the
  damped solve amplifies that to 1.7e-5..3.2e-5 m after 1 to 6 iterations
  (measured on three seeds).
"""

import json
import os

import numpy as np
import pytest
import torch

from port_bench import gen
from port_bench.reference import energies
from port_bench.reference import geometry as G
from port_bench.reference import pipeline as ref_pipeline
from port_bench.reference import solver as S
from triangulation_in_deformable_scenes_torch.models import block_system, deformable

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = deformable.MODELS["HyperElasticOdgen"]
PARAMS = [(1.0, 1.0), (2.0, 0.5)]


def _cfg(alpha=1.0, beta=1.0):
    with open(os.path.join(ROOT, "port_bench", "configs", "ogden240.json")) as f:
        cfg = json.load(f)
    return dict(cfg, num_points=40, alpha=alpha, beta=beta)


def _traffic():
    with open(os.path.join(ROOT, "port_bench", "traffic", "sweep_energy.json")) as f:
        return json.load(f)


def _problem(seed, dtype):
    """(reference data, reference hyper, port data, port hyper, state) of
    the seed's first condition, with the weights of its first inner solve."""
    cfg = _cfg()
    cond = gen.conditions(cfg, _traffic(), seed, 1)[0]
    rdata, state, _, _, _ = ref_pipeline.first_problem(cfg, cond.c2_pose, cond.orig, cond.moved, cond.noise_seed,
                                                       torch.device("cpu"))
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    rdata = rdata._replace(**{k: cast(v) for k, v in rdata._asdict().items()})
    state = state._replace(**{k: cast(v) for k, v in state._asdict().items()})
    f = lambda v: torch.tensor(v, dtype=dtype)
    rhyper = S.Hyper(rep_w=f(1.0), arap_w=f(cfg["start_weights"][2]), depth_sigma=f(cfg["depth_sigma_mm"] / 1000.0))
    ones = torch.ones_like(rdata.depth1)
    pdata = deformable.PairData(
        kp1=rdata.kp1, kp2=rdata.kp2, inv_sigma2_1=ones, inv_sigma2_2=ones, depth1=rdata.depth1,
        depth2=rdata.depth2, valid=rdata.valid, cam_params=rdata.cam, R1w=rdata.R1w, t1w=rdata.t1w, R2w=rdata.R2w,
        t2w=rdata.t2w, nbr=rdata.nbr, nbr_mask=rdata.nbr_mask, wcot=rdata.wcot, Ri=rdata.Ri, area=rdata.area,
        ntri=rdata.ntri, s1_prior=rdata.s1_prior, s2_prior=rdata.s2_prior, s1_info=rdata.s1_info,
        s2_info=rdata.s2_info,
    )
    return rdata, rhyper, pdata, state


def _phyper(rhyper, alpha, beta):
    f = lambda v: torch.tensor(v, dtype=rhyper.rep_w.dtype)
    return deformable.Hyper(rep_w=rhyper.rep_w, arap_w=rhyper.arap_w, depth_sigma=rhyper.depth_sigma,
                            global_w=f(1.0), alpha=f(alpha), beta=f(beta))


def _pstate(state):
    return deformable.PairState(*state)


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


@pytest.fixture(scope="module", params=[7, 2**31 + 3])
def f64(request):
    return _problem(request.param, torch.float64)


@pytest.mark.parametrize("alpha,beta", PARAMS)
def test_edge_energies_match(f64, alpha, beta):
    rdata, rhyper, pdata, state = f64
    got = deformable._arap_energies(pdata, _pstate(state), SPEC, _phyper(rhyper, alpha, beta))
    want = energies.edge_energies(rdata, state, alpha, beta)
    assert torch.equal(got == 0, want == 0)
    assert rel(got, want) <= 1e-9


@pytest.mark.parametrize("alpha,beta", PARAMS)
def test_robust_cost_matches(f64, alpha, beta):
    rdata, rhyper, pdata, state = f64
    got = deformable.robust_cost("KB8", pdata, _phyper(rhyper, alpha, beta), _pstate(state), SPEC)
    want = energies.robust_cost(_cfg(alpha, beta), rdata, rhyper, state)
    assert abs(float(got - want)) <= 1e-9 * abs(float(want))


@pytest.mark.parametrize("alpha,beta", PARAMS)
def test_dense_system_matches(f64, alpha, beta):
    rdata, rhyper, pdata, state = f64
    H, g = deformable.build_system("KB8", pdata, _phyper(rhyper, alpha, beta), _pstate(state), SPEC)
    H_ref, g_ref = energies.build_system(_cfg(alpha, beta), rdata, rhyper, state)
    assert rel(H, H_ref) <= 1e-9 and rel(g, g_ref) <= 1e-9


def test_block_system_matches(f64):
    """The port's block system, expanded column by column through its own
    matvec, against the reference's dense H and g."""
    rdata, rhyper, pdata, state = f64
    sys = block_system.build_block_system("KB8", pdata, _phyper(rhyper, 1.0, 1.0), _pstate(state), SPEC)
    H_ref, g_ref = energies.build_system(_cfg(), rdata, rhyper, state)
    eye = torch.eye(H_ref.shape[0], dtype=H_ref.dtype)
    H = torch.stack([block_system.block_matvec(sys, pdata.nbr, e, 0.0) for e in eye], dim=1)
    assert rel(H, H_ref) <= 1e-9 and rel(block_system.flat_gradient(sys), g_ref) <= 1e-9


@pytest.mark.parametrize("alpha,beta", PARAMS)
def test_slot_jacobian_is_autograd(f64, alpha, beta):
    """Each slot's weighted energy depends only on its own 18 coordinates,
    so the gradient of their sum holds every slot's Jacobian row."""
    rdata, rhyper, _, state = f64
    L, r = energies.slot_jacobian(rdata, rhyper, state, alpha, beta)
    n, K = rdata.nbr.shape
    j = torch.clamp(rdata.nbr, min=0)
    ii = torch.arange(n)[:, None].expand(n, K).reshape(-1)
    jj = j.reshape(-1)
    w_edge = ((rdata.nbr_mask & rdata.valid[:, None] & rdata.valid[j]).to(L.dtype)
              * torch.sqrt(rhyper.arap_w) * rdata.ntri).reshape(-1)
    x = torch.cat([state.p1[ii], state.p2[ii], state.p1[jj], state.p2[jj], torch.zeros((n * K, 6), dtype=L.dtype)],
                  dim=-1).requires_grad_(True)
    dR, dt = G.se3_exp(x[:, 12:18])
    Rg, tg = G.compose(dR, dt, state.Rg, state.tg)
    e = energies.edge_energy(x[:, 0:3], x[:, 3:6], x[:, 6:9], x[:, 9:12], rdata.wcot.reshape(-1), rdata.area,
                             Rg, tg, alpha, beta)
    (L_ad,) = torch.autograd.grad(torch.sum(w_edge * e), x)
    assert rel(r, w_edge * e.detach()) <= 1e-9
    assert rel(L, L_ad) <= 1e-9


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_pair_matches(dtype):
    rdata, rhyper, pdata, state = _problem(11, dtype)
    got = deformable.solve_pair("KB8", pdata, _phyper(rhyper, 1.0, 1.0), _pstate(state), 6, SPEC)
    want = energies.solve_pair(_cfg(), rdata, rhyper, state, 6)
    assert got.n_accepted == want.n_accepted == 6
    v = rdata.valid
    gap = max(float((got.state.p1 - want.state.p1)[v].abs().max()), float((got.state.p2 - want.state.p2)[v].abs().max()))
    if dtype == torch.float64:
        assert got.n_solves == want.n_solves and gap <= 1e-9
        assert abs(float(got.cost - want.cost)) <= 1e-9 * abs(float(want.cost))
    else:
        assert gap <= 1e-4


def test_dense_only():
    cfg = dict(_cfg(), num_points=700)
    with pytest.raises(ValueError, match="dense only"):
        energies.run_condition(cfg, (0.1, 0.0, 0.0), np.zeros((700, 3)), np.zeros((700, 3)), 1, torch.device("cpu"))
