"""The two remaining selections of the outer loop against the JAX package's:
``open3DArap`` (``ops/arap.arap_deform``) and the ``eigen`` weights selection
(``outer._numdiff_lm``), on the CPU.

Tolerances:

- ``arap_deform`` on the same mesh: 1e-5 m (one f32 LU of the same
  Laplacian on each side, reused by every step; the rotation fits are f32
  SVDs);
- ``_numdiff_lm``: equal (the same numpy in both packages);
- the selections through ``SimulationPipeline`` on the reduced sweep fixture
  (60 points): ``open3DArap`` final mean 3D error within 1e-5 m and weights
  within 1e-5 relative (they do not move); ``eigen`` final within 1e-3
  relative and weights within 1e-2 relative. The eigen LM takes forward
  differences (step 1e-3 relative) of f32 inner solves, which turn the two
  packages' last-ulp differences into slightly different Jacobians and
  steps (measured: arap weight 9994.9 against 10013.7, final 9.4383 against
  9.4412 mm, 0.03 %).

Those steps are the f32 rounding's, not the objective's: at 2 LM iterations
JAX's first residual moves 0.14 % between ARAP weights 1e4 and 1.001e4, and
2 % between 1e4 and 0.1, so over a step of 1e-3 of the weight the rounding
outweighs the slope hundreds of times. So
``test_eigen_residuals_and_steps_match_jax`` holds the branch itself: the
residuals at fixed weights (within 2e-3 relative; 8.9e-4 measured at 2 LM
iterations, where they range from 1.9 to 7.0), and the LM from an ARAP
weight of 0.1 with a forward-difference step of half the weight, wide
enough that the slope outweighs the rounding: each package's evaluated
weights equal within 1e-9 relative (equal measured), the same move down
to the 1e-5 bound, finals within 1e-5 relative (7.6e-7 measured).

Run as a script, it prints JAX's values of that wide-step run, which
``chip_smoke.py`` holds the card to, and the residuals at the fixed weights
(``--port``: the port's too, and the differences quoted above):

    JAX_PLATFORMS=cpu python tests/test_torch_selections.py
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_torch_problems import run_pipeline
from triangulation_in_deformable_scenes_torch.harness import sweep_config as sc
from triangulation_in_deformable_scenes_torch.models import outer as t_outer
from triangulation_in_deformable_scenes_torch.ops import arap as t_arap
from triangulation_in_deformable_scenes_torch.ops import mesh as t_mesh
from triangulation_in_deformable_scenes_tpu.models import outer as j_outer
from triangulation_in_deformable_scenes_tpu.ops import arap as j_arap

torch.set_num_threads(1)


def _mesh(n=80, seed=0):
    p = sc.sweep_points(n, seed)[0].astype(np.float32)
    ctx = t_mesh.build_mesh_context(p, backend=sc.MESH_BACKEND)
    return p, ctx


@pytest.mark.parametrize("constraints", [[0], [0, 7, 31]])
def test_arap_deform_matches_jax(constraints):
    import jax.numpy as jnp

    p, ctx = _mesh()
    rng = np.random.default_rng(1)
    cpos = (p[constraints] + rng.normal(scale=0.003, size=(len(constraints), 3))).astype(np.float32)
    kw = dict(constraint_idx=constraints, iters=10)
    want = np.asarray(j_arap.arap_deform(jnp.asarray(p), jnp.asarray(ctx.nbr), jnp.asarray(ctx.nbr_mask),
                                         jnp.asarray(ctx.weights, jnp.float32), constraint_pos=jnp.asarray(cpos),
                                         **{**kw, "constraint_idx": jnp.asarray(constraints)}))
    got = t_arap.arap_deform(torch.as_tensor(p), torch.as_tensor(ctx.nbr, dtype=torch.int64),
                             torch.as_tensor(ctx.nbr_mask), torch.as_tensor(ctx.weights, dtype=torch.float32),
                             constraint_pos=torch.as_tensor(cpos),
                             **{**kw, "constraint_idx": torch.as_tensor(constraints)}).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[constraints], cpos, atol=1e-5)
    assert np.abs(got - p).max() > 1e-4  # the mesh moved


def test_numdiff_lm_equals_jax():
    """A two-residual problem with one frozen weight, the eigen selection's
    shape: the same iterate for the same evaluations."""
    target = np.array([2.0, 1.0, 30.0])

    def residuals(x):
        return np.array([np.log(x[0] / target[0]) ** 2 + 0.1, (np.log10(x[2]) - np.log10(target[2])) ** 2])

    lb, ub = np.array([0.5, 1.0, 1e-5]), np.array([4.0, 1.0, 1e7])
    for max_evals in (3, 10, 25):
        got = t_outer._numdiff_lm(residuals, [1.0, 1.0, 1e4], lb, ub, max_evals=max_evals)
        want = j_outer._numdiff_lm(residuals, [1.0, 1.0, 1e4], lb, ub, max_evals=max_evals)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("selection,rounds,evals,iters,tol,wtol", [
    ("open3DArap", 2, 1, 10, 1e-5, 1e-5),
    ("eigen", 1, 1, 5, 1e-3 * 9.44e-3, 1e-2),
])
def test_selection_matches_jax(tmp_path, selection, rounds, evals, iters, tol, wtol):
    over = {"opt_selection": "open3DArap"} if selection == "open3DArap" else {"opt_weights_selection": "eigen"}
    rj, _ = run_pipeline("jax", 60, 0, rounds, evals, iters, str(tmp_path / "j"), overrides=over)
    rt, _ = run_pipeline("torch", 60, 0, rounds, evals, iters, str(tmp_path / "t"), device="cpu", overrides=over)
    np.testing.assert_array_equal(rt.valid, rj.valid)
    assert abs(rt.initial.av_error - rj.initial.av_error) < 1e-6
    assert np.isfinite(rt.final.av_error)
    assert abs(rt.final.av_error - rj.final.av_error) < tol, (rt.final.av_error, rj.final.av_error)
    assert rt.rounds == rj.rounds
    np.testing.assert_allclose(rt.weights, rj.weights, rtol=wtol)
    if selection == "open3DArap":
        assert abs(rt.final.av_error - rt.initial.av_error) > 1e-6  # the deformation moved the map


# The wide-step eigen run: ARAP weight 0.1, one round of 2 LM iterations, and
# weights probed at fixed values spanning the objective's range.
WIDE_EPS_REL = 0.5
WIDE_OVERRIDES = {"opt_weights_selection": "eigen", "opt_arap_weight": 0.1}
WIDE_BUDGET = dict(rounds=1, evals=1, iters=2)
EIGEN_PROBES = ((1.0, 1.0, 1e4), (1.0, 1.0, 1.001e4), (1.0, 1.0, 1e-1), (1.0, 1.0, 1e-3), (1.0, 1.0, 1e-5), (2.0, 1.0, 1e-3))


def _recording_lm(outer_module, log):
    """``outer_module._numdiff_lm`` with the wide step that records its
    call, the residuals at ``EIGEN_PROBES``, each evaluation and its result."""
    real = outer_module._numdiff_lm

    def lm(residuals, x0, lb, ub, max_evals=10):
        log.update(x0=np.array(x0, dtype=np.float64), lb=lb, ub=ub, max_evals=max_evals, steps=[],
                   probes=[residuals(np.array(x)) for x in EIGEN_PROBES])

        def recorded(x):
            r = residuals(x)
            log["steps"].append((np.array(x), r))
            return r

        log["out"] = real(recorded, x0, lb, ub, max_evals=max_evals, eps_rel=WIDE_EPS_REL)
        return log["out"]

    return lm


def run_wide_eigen(package, workdir):
    """One package's wide-step eigen run; returns (result, log)."""
    log = {}
    mod = j_outer if package == "jax" else t_outer
    real = mod._numdiff_lm
    mod._numdiff_lm = _recording_lm(mod, log)
    try:
        res, _ = run_pipeline(package, 60, 0, WIDE_BUDGET["rounds"], WIDE_BUDGET["evals"], WIDE_BUDGET["iters"],
                              workdir, device="cpu", overrides=WIDE_OVERRIDES)
    finally:
        mod._numdiff_lm = real
    return res, log


def test_eigen_residuals_and_steps_match_jax(tmp_path):
    rj, lj = run_wide_eigen("jax", str(tmp_path / "j"))
    rt, lt = run_wide_eigen("torch", str(tmp_path / "t"))
    # The LM's call: the configured start, the bounds, JAX's budget.
    np.testing.assert_array_equal(lt["x0"], lj["x0"])
    np.testing.assert_array_equal(lt["lb"], lj["lb"])
    np.testing.assert_array_equal(lt["ub"], lj["ub"])
    assert lt["max_evals"] == lj["max_evals"] == 10
    # The residuals at fixed weights: (log sigma_c1)^2 and (log sigma_c2)^2
    # of the same inner solve, far apart across the probes.
    pj, pt = np.array(lj["probes"]), np.array(lt["probes"])
    assert pj.min() > 1.0 and pj[0, 0] / pj[4, 0] > 2.0
    np.testing.assert_allclose(pt, pj, rtol=2e-3)
    # The LM's evaluations and result: the same weights tried, in order.
    assert len(lt["steps"]) == len(lj["steps"]) == 10
    for (xt, r_t), (xj, r_j) in zip(lt["steps"], lj["steps"]):
        np.testing.assert_allclose(xt, xj, rtol=1e-9)
        np.testing.assert_allclose(r_t, r_j, rtol=2e-3)
    assert lj["out"][2] <= 1e-3 and lt["out"][2] <= 1e-3  # down from 0.1, more than two decades
    np.testing.assert_allclose(lt["out"], lj["out"], rtol=1e-9)
    # The branch takes the LM's weights for its final solve.
    np.testing.assert_array_equal(rt.weights, lt["out"])
    np.testing.assert_array_equal(rj.weights, lj["out"])
    assert abs(rt.final.av_error - rj.final.av_error) < 1e-5 * rj.final.av_error


@pytest.mark.cuda
def test_arap_deform_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p, ctx = _mesh()
    args = [torch.as_tensor(p), torch.as_tensor(ctx.nbr, dtype=torch.int64), torch.as_tensor(ctx.nbr_mask),
            torch.as_tensor(ctx.weights, dtype=torch.float32), torch.tensor([0]), torch.as_tensor(p[:1] + 0.002)]
    cpu = t_arap.arap_deform(*args, iters=10)
    card = t_arap.arap_deform(*(a.cuda() for a in args), iters=10)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-5)


def _main(argv):
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for package in ("jax", "torch") if "--port" in argv else ("jax",):
            res, log = runs[package] = run_wide_eigen(package, os.path.join(tmp, package))
            print(f"{package} wide-step eigen: weights={res.weights.tolist()} evaluations={len(log['steps'])}")
            print(f"initial_av_error_m={res.initial.av_error!r} final_av_error_m={res.final.av_error!r}")
            for x, r in zip(EIGEN_PROBES, log["probes"]):
                print(f"  residuals at {x}: {r.tolist()}")
    if len(runs) == 2:
        (rj, lj), (rt, lt) = runs["jax"], runs["torch"]
        pj, pt = np.array(lj["probes"]), np.array(lt["probes"])
        print(f"residuals at fixed weights: max relative difference {np.max(np.abs(pt - pj) / np.abs(pj)):.2e}")
        xs = max(np.max(np.abs(xt - xj) / np.abs(xj)) for (xt, _), (xj, _) in zip(lt["steps"], lj["steps"]))
        print(f"evaluated weights: max relative difference {xs:.2e}; final error relative difference "
              f"{abs(rt.final.av_error - rj.final.av_error) / rj.final.av_error:.2e}")


if __name__ == "__main__":
    _main(sys.argv[1:])
