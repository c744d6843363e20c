"""Parity of the port's deformable model, LM and rigid solve with the JAX
package, on identical numpy inputs (``test_torch_problems``), on the CPU.

Both packages compute in f32. Tolerances are stated per test: assembled
quantities are compared relative to their largest entry; solver outputs are
compared after a full LM run, where f32 summation-order differences are
amplified by the accept/reject decisions, so the asks there are looser and
say why.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_problems import deforming_problem, jax_problem, rigid_problem, torch_problem
from triangulation_in_deformable_scenes_torch.models import deformable as t_def
from triangulation_in_deformable_scenes_torch.models import rigid as t_rigid
from triangulation_in_deformable_scenes_torch.ops import lm as t_lm
from triangulation_in_deformable_scenes_tpu.models import deformable as j_def
from triangulation_in_deformable_scenes_tpu.models import rigid as j_rigid
from triangulation_in_deformable_scenes_tpu.ops import lm as j_lm

torch.set_num_threads(1)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.fixture(scope="module")
def problem():
    pb = deforming_problem()
    return pb, jax_problem(pb), torch_problem(pb)


def test_pair_data_matches(problem):
    """make_pair_data: same mesh (exact), same cot weights and frozen ARAP
    rotations to f32 precision."""
    _, (jd, _, _), (td, _, _) = problem
    np.testing.assert_array_equal(td.nbr.numpy(), np.asarray(jd.nbr))
    np.testing.assert_array_equal(td.nbr_mask.numpy(), np.asarray(jd.nbr_mask))
    assert rel(td.wcot, jd.wcot) < 1e-6
    assert rel(td.Ri, jd.Ri) < 1e-5
    assert float(td.ntri) == float(jd.ntri)
    assert rel(td.area, jd.area) < 1e-6


@pytest.mark.parametrize(
    "model", ["ARAP", "ARAP_OneSet", "Elastic", "HyperElasticOdgen", "ARAP_NoGlobal",
              "ARAP_not_scaled_depth", "ARAP_squared_depth", "ARAP_depth_onlyTriang"]
)
def test_robust_cost_and_residuals_match(problem, model):
    """robust_cost and the weighted residual vector for a default model,
    ARAP_OneSet, Elastic, Ogden and the depth modes: 1e-5 relative (sums of
    a few thousand f32 terms)."""
    _, (jd, js, jh), (td, ts, th) = problem
    spec_t, spec_j = t_def.MODELS[model], j_def.MODELS[model]
    ct = t_def.robust_cost("KB8", td, th, ts, spec_t)
    cj = j_def.robust_cost("KB8", jd, jh, js, spec_j)
    assert abs(float(ct) - float(cj)) / abs(float(cj)) < 1e-5
    rt = t_def.residual_vector("KB8", td, th, ts, spec_t)
    rj = j_def.residual_vector("KB8", jd, jh, js, spec_j)
    assert rel(rt, rj) < 1e-5


@pytest.mark.parametrize("model", ["ARAP", "Elastic", "ARAP_OneSet", "ARAP_not_scaled_depth"])
def test_build_system_matches_jax(problem, model):
    """Gauss-Newton (H, g): 1e-4 of the largest entry (J^T J sums hundreds of
    products of f32 local Jacobians whose entries span 1e-3..1e4)."""
    _, (jd, js, jh), (td, ts, th) = problem
    Ht, gt = t_def.build_system("KB8", td, th, ts, t_def.MODELS[model])
    Hj, gj = j_def.build_system("KB8", jd, jh, js, j_def.MODELS[model])
    assert rel(Ht, Hj) < 1e-4
    assert rel(gt, gj) < 1e-4


def test_block_assembly_matches_jacfwd_oracle(problem):
    """The port's own two assemblies agree (the JAX package pins the same
    invariant at 1e-12 in f64; here f32, 1e-4 of the largest entry)."""
    _, _, (td, ts, th) = problem
    for name in ("ARAP", "HyperElasticOdgen", "ARAP_squared_depth"):
        spec = t_def.MODELS[name]
        Hb, gb = t_def.build_system("KB8", td, th, ts, spec)
        Hf, gf = t_def.build_system_jacfwd("KB8", td, th, ts, spec)
        assert rel(Hb, Hf) < 1e-4, name
        assert rel(gb, gf) < 1e-4, name


def test_masked_edge_rows_are_zero(problem):
    """Scatter-set invariant (``deformable.build_system``): padded mesh-edge
    slots carry identically-zero local Jacobians and residuals, for every
    edge family."""
    _, _, (td, ts, th) = problem
    n, K = td.nbr.shape
    mask = td.nbr_mask.reshape(-1).numpy()
    assert not mask.all(), "fixture must exercise padded neighbor slots"
    for name in ("ARAP", "Elastic", "HyperElasticOdgen", "ARAP_NoGlobal"):
        blocks = [(L, r) for L, r, _ in t_def._edge_blocks("KB8", td, th, ts, t_def.MODELS[name])
                  if L.shape[0] == n * K]
        assert blocks, name
        for L, r in blocks:
            assert np.all(L.numpy()[~mask] == 0.0), name
            assert np.all(r.numpy()[~mask] == 0.0), name


@pytest.mark.parametrize("model", ["ARAP", "Elastic"])
@pytest.mark.parametrize("n_iterations", [8, 25])
def test_solve_pair_matches_jax(problem, model, n_iterations):
    """solve_pair at fixed weights. Through 8 iterations, before either
    converges, the (lambda, accept) schedules are identical: the same
    n_accepted, final cost within 1e-4 relative, points within 1e-6 m. At
    25 iterations both have converged to the noise floor; lambda then grows
    to ~1e20 and whether a last step is accepted rides on f32 noise in the
    gain ratio, so n_accepted is only required to reach the converged count
    and the cost and points keep 1e-4 relative and 1e-5 m."""
    pb, (jd, js, jh), (td, ts, th) = problem
    rt = t_def.solve_pair("KB8", td, th, ts, n_iterations, t_def.MODELS[model])
    rj = j_def.solve_pair("KB8", jd, jh, js, n_iterations, j_def.MODELS[model])
    if n_iterations == 8:
        assert rt.n_accepted == int(rj.n_accepted) == 8
        atol = 1e-6
    else:
        assert rt.n_accepted >= 8 and int(rj.n_accepted) >= 8
        atol = 1e-5
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * abs(float(rj.cost))
    assert float(rt.cost) < 0.1 * float(rt.initial_cost)
    for a, b in ((rt.state.p1, rj.state.p1), (rt.state.p2, rj.state.p2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


def test_lm_linear_least_squares_matches_jax():
    """The LM loop on a linear problem (tests/test_lm.py): both land on the
    normal-equation solution and take the same schedule."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 8)).astype(np.float32)
    b = rng.normal(size=30).astype(np.float32)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    rt = t_lm.lm_optimize(lambda x: (At.T @ At, At.T @ (At @ x - bt)),
                          lambda x: torch.sum((At @ x - bt) ** 2),
                          lambda x, d: x + d, torch.zeros(8), n_iterations=10)
    rj = j_lm.lm_optimize(lambda x: (Aj.T @ Aj, Aj.T @ (Aj @ x - bj)),
                          lambda x: jnp.sum((Aj @ x - bj) ** 2),
                          lambda x, d: x + d, jnp.zeros(8), n_iterations=10)
    x_star = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64), rcond=None)[0]
    np.testing.assert_allclose(rt.state.numpy(), x_star, atol=2e-5)
    np.testing.assert_allclose(rt.state.numpy(), np.asarray(rj.state), atol=2e-5)
    assert rt.n_accepted == int(rj.n_accepted)
    assert rt.n_solves >= rt.n_accepted


def test_lm_rosenbrock_matches_jax():
    """Non-convex: same accepted-iteration count and the same minimum."""

    def res_t(x):
        # 1-d slices, not 0-d scalars (see ops/lie.py on forward-mode AD).
        x0, x1 = x[:1], x[1:]
        return torch.cat([10.0 * (x1 - x0**2), 1.0 - x0])

    def res_j(x):
        return jnp.array([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    def build_t(x):
        r = res_t(x)
        Jx = torch.func.jacfwd(res_t)(x)
        return Jx.T @ Jx, Jx.T @ r

    import jax

    def build_j(x):
        r = res_j(x)
        Jx = jax.jacfwd(res_j)(x)
        return Jx.T @ Jx, Jx.T @ r

    rt = t_lm.lm_optimize(build_t, lambda x: torch.sum(res_t(x) ** 2), lambda x, d: x + d,
                          torch.tensor([-1.2, 1.0]), n_iterations=50)
    rj = j_lm.lm_optimize(build_j, lambda x: jnp.sum(res_j(x) ** 2), lambda x, d: x + d,
                          jnp.array([-1.2, 1.0]), n_iterations=50)
    np.testing.assert_allclose(rt.state.numpy(), [1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(rt.state.numpy(), np.asarray(rj.state), atol=1e-5)
    assert abs(rt.n_accepted - int(rj.n_accepted)) <= 1


def test_solve_rigid_matches_jax():
    """solve_rigid on an exactly-rigid scene (tests/test_rigid.py): both
    denoise below the 3 mm depth floor and agree on the refined points to
    0.1 mm and on the diagnostics to 1e-3 relative (two multi-start rounds of
    30 LM iterations each, f32)."""
    pb = rigid_problem()
    jd, js, jh = jax_problem(pb)
    td, ts, th = torch_problem(pb)
    spec_j, spec_t = j_def.MODELS["ARAP_depth_3mm"], t_def.MODELS["ARAP_depth_3mm"]
    cj, dj = j_rigid.solve_rigid("KB8", jd, jh, js, 30, spec_j)
    ct, dt_ = t_rigid.solve_rigid("KB8", td, th, ts, 30, spec_t)
    err_t = np.linalg.norm(ct.p1.numpy() - pb["p1_gt"], axis=-1).mean()
    err_j = np.linalg.norm(np.asarray(cj.p1) - pb["p1_gt"], axis=-1).mean()
    assert err_t < 0.003 and err_j < 0.003
    np.testing.assert_allclose(ct.p1.numpy(), np.asarray(cj.p1), atol=1e-4)
    np.testing.assert_allclose(ct.p2.numpy(), np.asarray(cj.p2), atol=1e-4)
    for a, b in zip(dt_, dj):
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b)) + 1e-7


def test_solve_pair_dispatch_matches_jax(problem, monkeypatch):
    """use_dense_backend agrees with the JAX package's on the cases of
    tests/test_block_system.py (dense limit and batch-wide Jacobian budget),
    and above the dense limit solve_pair runs lm_optimize_general over
    make_block_step, never the dense assembly."""
    from triangulation_in_deformable_scenes_torch.models import block_system as t_bs

    for n, K, batch in ((240, 32, 1), (240, 32, 16), (680, 32, 16), (1000, 32, 1)):
        assert t_def.use_dense_backend(n, K, batch) == j_def.use_dense_backend(n, K, batch)
    assert not t_def.use_dense_backend(861, 32)  # the reference's dim 5174

    _, _, (td, ts, th) = problem
    spec = t_def.MODELS["ARAP"]
    steps = []
    make_block_step = t_bs.make_block_step

    def spy(*args, **kwargs):
        steps.append(args)
        return make_block_step(*args, **kwargs)

    def no_dense(*args, **kwargs):
        raise AssertionError("the dense assembly ran above the dense limit")

    monkeypatch.setattr(t_def, "DENSE_DIM_LIMIT", 6 * ts.p1.shape[0])
    monkeypatch.setattr(t_bs, "make_block_step", spy)
    monkeypatch.setattr(t_def, "build_system", no_dense)
    res = t_def.solve_pair("KB8", td, th, ts, 3, spec)
    assert len(steps) == 1 and steps[0][4:] == (t_def.CG_ITERS, t_def.CG_RTOL)
    want = t_lm.lm_optimize_general(
        make_block_step("KB8", td, th, spec, t_def.CG_ITERS, t_def.CG_RTOL),
        lambda s: t_def.robust_cost("KB8", td, th, s, spec), t_def.apply_delta_spec(spec), ts, 3)
    assert res.n_accepted == want.n_accepted == 3
    assert torch.equal(res.state.p1, want.state.p1) and torch.equal(res.cost, want.cost)
