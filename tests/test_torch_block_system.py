"""Parity of the port's large-N backend (``models/block_system.py``,
``ops/block_pcg.py``) with the JAX package, on identical numpy inputs
(``test_torch_problems``), on the CPU.

Tolerances, each with its reason:

- block assembly against the JAX package: every block within 1e-4 of its
  largest entry (sums of a few hundred f32 products whose entries span
  ~1e-3..1e7; measured <= 4e-6), and against the port's own dense
  ``build_system`` with the JAX test's own limits
  (``tests/test_block_system.py``);
- ``inv6_spd``: within 1e-4 of each block's largest entry of the JAX
  function's result (the same unrolled f32 steps; rsqrt and sqrt may differ
  by an ulp, amplified by the block's condition up to ~1e5; measured
  <= 6e-6), and ||X A - I|| < 5e-4 as the JAX test asks;
- PCG: the plain loop takes exactly the JAX loop's iteration count and
  lands within 1e-4 of max|x| (the same f32 recurrence from identical
  inputs; measured ~3e-7); against the Pallas kernel in interpret mode
  1e-3, as ``tests/test_pallas_pcg.py`` holds it;
- the LM loop on the block backend: the same accepted count through the
  iterations before convergence, cost within 1e-4 relative, lambda within
  1e-3 relative (a product of accept factors, each an f32 cubic of the
  gain ratio), points within 1e-6 m.

The CUDA kernel is held against the plain version only on a card (marked
``cuda``; it skips here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_problems import deforming_problem, jax_problem, torch_problem
from triangulation_in_deformable_scenes_torch.models import block_system as t_bs
from triangulation_in_deformable_scenes_torch.models import deformable as t_def
from triangulation_in_deformable_scenes_torch.ops import block_pcg
from triangulation_in_deformable_scenes_torch.ops import lm as t_lm
from triangulation_in_deformable_scenes_tpu.models import block_system as j_bs
from triangulation_in_deformable_scenes_tpu.models import deformable as j_def
from triangulation_in_deformable_scenes_tpu.ops import lm as j_lm
from triangulation_in_deformable_scenes_tpu.ops import pallas_pcg

torch.set_num_threads(1)

SPECS = ["ARAP", "ARAP_NoGlobal", "ARAP_OneSet", "ARAP_not_scaled_depth", "ARAP_depth_onlyTriang",
         "ARAP_squared_depth", "Elastic", "HyperElasticOdgen"]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.fixture(scope="module")
def small():
    """The 16-point problem of tests/test_block_system.py."""
    pb = deforming_problem(n_side=4)
    return jax_problem(pb), torch_problem(pb)


@pytest.fixture(scope="module")
def pcg_problem():
    return pcg_problem_cpu()


def pcg_problem_cpu():
    """The 36-point system of tests/test_pallas_pcg.py, assembled by the JAX
    package; the port gets the same blocks as tensors, so the solvers are
    compared on identical inputs."""
    pb = deforming_problem(n_side=6)
    jd, js, jh = jax_problem(pb)
    sys_j = j_bs.build_block_system("KB8", jd, jh, js)
    sys_t = t_bs.BlockSystem(*(torch.as_tensor(np.array(a)) for a in sys_j))
    g = j_bs.flat_gradient(sys_j)
    lam = 1e-4 * float(jnp.max(j_bs.diag_of(sys_j)))
    nbr_t = torch.as_tensor(np.array(jd.nbr))
    return sys_j, jd.nbr, g, sys_t, nbr_t, -torch.as_tensor(np.array(g)), lam


@pytest.mark.parametrize("model", SPECS)
def test_build_block_system_matches_jax(small, model):
    (jd, js, jh), (td, ts, th) = small
    sj = j_bs.build_block_system("KB8", jd, jh, js, j_def.MODELS[model])
    st = t_bs.build_block_system("KB8", td, th, ts, t_def.MODELS[model])
    for name in t_bs.BlockSystem._fields:
        assert rel(getattr(st, name), getattr(sj, name)) < 1e-4, name


@pytest.mark.parametrize("model", SPECS)
def test_block_operator_matches_dense_build_system(small, model):
    """flat_gradient, diag_of and block_matvec against the port's dense
    (H, g), with tests/test_block_system.py's limits."""
    _, (td, ts, th) = small
    spec = t_def.MODELS[model]
    n = ts.p1.shape[0]
    H, g = t_def.build_system("KB8", td, th, ts, spec)
    sys = t_bs.build_block_system("KB8", td, th, ts, spec)
    np.testing.assert_allclose(t_bs.flat_gradient(sys).numpy(), g.numpy(), rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(t_bs.diag_of(sys).numpy(), torch.diagonal(H).numpy(), rtol=2e-4, atol=1e-7)
    rng = np.random.default_rng(0)
    scale = max(float(H.abs().max()), 1.0)
    for _ in range(3):
        v = torch.as_tensor(rng.normal(size=6 * n + 8).astype(np.float32))
        np.testing.assert_allclose(t_bs.block_matvec(sys, td.nbr, v, 0.5).numpy(), (H @ v + 0.5 * v).numpy(),
                                   rtol=2e-4, atol=2e-5 * scale)


def test_inv6_spd_matches_jax():
    """The grid of tests/test_block_system.py::test_inv6_spd_matches_linalg_inv."""
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 1e5):
        J = rng.normal(size=(64, 9, 6)) * scale
        M = np.einsum("nra,nrb->nab", J, J)
        for lam in (1e-6 * scale**2, 1.0, 1e3 * scale**2):
            A = (M + lam * np.eye(6)[None]).astype(np.float32)
            want = np.asarray(j_bs.inv6_spd(jnp.asarray(A)))
            got = t_bs.inv6_spd(torch.as_tensor(A)).numpy()
            err = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
            assert err.max() < 1e-4, (scale, lam, err.max())
            eye = np.einsum("nab,nbc->nac", got.astype(np.float64), A.astype(np.float64))
            assert np.abs(eye - np.eye(6)).max() < 5e-4, (scale, lam)


def test_block_jacobi_is_exact_on_the_global_block(pcg_problem):
    """On the 8 global rows the preconditioner is the inverse of Hg + lam I."""
    _, _, _, sys_t, _, _, _ = pcg_problem
    n = sys_t.D.shape[0]
    r = torch.zeros(6 * n + 8)
    r[6 * n :] = torch.arange(1.0, 9.0)
    x = t_bs.block_jacobi_apply(sys_t, 0.1)(r)
    want = np.linalg.solve(sys_t.Hg.double().numpy() + 0.1 * np.eye(8), np.arange(1.0, 9.0))
    np.testing.assert_allclose(x[6 * n :].numpy(), want, rtol=1e-5)
    assert float(x[: 6 * n].abs().max()) == 0.0


def _jax_iterations(mv, b, precond, rtol, k):
    """Whether the JAX pcg_flex stopped after exactly k iterations: its x at
    the cap k equals its x at the cap 64, and at the cap k - 1 does not."""
    x = {cap: np.asarray(j_bs.pcg_flex(mv, b, precond, cap, rtol)) for cap in (64, k, k - 1)}
    return np.array_equal(x[k], x[64]) and not np.array_equal(x[k - 1], x[64]), x[64]


@pytest.mark.parametrize("rtol", [1e-2, 1e-6])
def test_pcg_plain_matches_jax_pcg_flex(pcg_problem, rtol):
    """At the production tolerance CG_RTOL and at 1e-6: the same iteration
    count as the JAX loop, x within 1e-4 of max|x|."""
    sys_j, nbr_j, g, sys_t, nbr_t, b_t, lam = pcg_problem
    x, k = block_pcg.pcg_block_system_plain(sys_t, nbr_t, b_t, lam, 64, rtol)
    assert 1 < k < 64
    mv = lambda v: j_bs.block_matvec(sys_j, nbr_j, v, lam)
    same_k, xj = _jax_iterations(mv, -g, j_bs.block_jacobi_apply(sys_j, lam), rtol, k)
    assert same_k, k
    assert rel(x, xj) < 1e-4


def test_pcg_plain_matches_pallas_interpret(pcg_problem):
    """tests/test_pallas_pcg.py's case: both solve to rtol 1e-6, agree to
    1e-3 of max|x|, and the plain x solves the system to 1e-4."""
    sys_j, nbr_j, g, sys_t, nbr_t, b_t, lam = pcg_problem
    x, _ = block_pcg.pcg_block_system_plain(sys_t, nbr_t, b_t, lam, 64, 1e-6)
    xp = pallas_pcg.pcg_block_system(sys_j, nbr_j, -g, lam, iters=64, rtol=1e-6, interpret=True)
    assert rel(x, xp) < 1e-3
    res = t_bs.block_matvec(sys_t, nbr_t, x, lam) - b_t
    assert float(torch.linalg.norm(res)) <= 1e-4 * float(torch.linalg.norm(b_t))


def test_pcg_runs_the_cap_at_zero_tolerance(pcg_problem):
    """rtol 0 leaves only the cap; a loose tolerance exits early, and the
    dispatcher returns the plain x for a CPU tensor."""
    _, _, _, sys_t, nbr_t, b_t, lam = pcg_problem
    _, k = block_pcg.pcg_block_system_plain(sys_t, nbr_t, b_t, lam, 7, 0.0)
    assert k == 7
    x_loose, k_loose = block_pcg.pcg_block_system_plain(sys_t, nbr_t, b_t, lam, 64, 0.5)
    assert k_loose < 7
    assert torch.equal(block_pcg.pcg_block_system(sys_t, nbr_t, b_t, lam, 64, 0.5), x_loose)


def test_kernel_wrapper_rejects_cpu_tensors(pcg_problem):
    """The kernel wrapper takes CUDA tensors only: no fallback."""
    _, _, _, sys_t, nbr_t, b_t, lam = pcg_problem
    with pytest.raises(ValueError):
        block_pcg.pcg_block_system_cuda(sys_t, nbr_t, b_t, lam, 64, 1e-2)


@pytest.mark.parametrize("model,iterations", [("ARAP", 8), ("Elastic", 4)])
def test_block_lm_matches_jax(small, model, iterations):
    """lm_optimize_general over make_block_step at fixed weights, with the
    production CG_ITERS and CG_RTOL, through the iterations before either
    converges: Elastic reaches its noise floor at iteration 4, after which
    lambda and the accept decisions ride on f32 noise in the gain ratio."""
    (jd, js, jh), (td, ts, th) = small
    spec_j, spec_t = j_def.MODELS[model], t_def.MODELS[model]

    @jax.jit
    def run_j(d, h, s):
        step = j_bs.make_block_step("KB8", d, h, spec_j, j_def.CG_ITERS, j_def.CG_RTOL)
        return j_lm.lm_optimize_general(step, lambda x: j_def.robust_cost("KB8", d, h, x, spec_j),
                                        j_def.apply_delta_spec(spec_j), s, iterations)

    rj = run_j(jd, jh, js)
    step = t_bs.make_block_step("KB8", td, th, spec_t, t_def.CG_ITERS, t_def.CG_RTOL)
    rt = t_lm.lm_optimize_general(step, lambda x: t_def.robust_cost("KB8", td, th, x, spec_t),
                                  t_def.apply_delta_spec(spec_t), ts, iterations)
    assert rt.n_accepted == int(rj.n_accepted) == iterations
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * abs(float(rj.cost))
    assert float(rt.cost) < 0.1 * float(rt.initial_cost)
    assert abs(float(rt.lam) - float(rj.lam)) <= 1e-3 * abs(float(rj.lam))
    for a, b in ((rt.state.p1, rj.state.p1), (rt.state.p2, rj.state.p2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("rtol", [1e-2, 1e-6])
def test_cuda_pcg_kernel_matches_plain(pcg_problem, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    _, _, _, sys_t, nbr_t, b_t, lam = pcg_problem
    sys_c = t_bs.BlockSystem(*(a.cuda() for a in sys_t))
    nbr_c, b_c = nbr_t.cuda(), b_t.cuda()
    before = block_pcg.LAUNCHES
    x, k = block_pcg.pcg_block_system_cuda(sys_c, nbr_c, b_c, lam, 64, rtol)
    torch.cuda.synchronize()
    assert block_pcg.LAUNCHES == before + 1
    xp, kp = block_pcg.pcg_block_system_plain(sys_c, nbr_c, b_c, lam, 64, rtol)
    assert int(k) == kp
    assert rel(x.cpu(), xp.cpu()) < 1e-4
    _, k0 = block_pcg.pcg_block_system_cuda(sys_c, nbr_c, b_c, lam, 9, 0.0)
    assert int(k0) == 9
    for _ in range(20):
        xr, kr = block_pcg.pcg_block_system_cuda(sys_c, nbr_c, b_c, lam, 64, rtol)
        assert torch.equal(xr, x) and int(kr) == int(k)


def _repeated(sys_t, nbr_t, m):
    """The system as m independent copies of its points (the global block
    scaled by m, so the whole stays positive definite)."""
    n = nbr_t.shape[0]
    tile = lambda t: t.repeat(m, *([1] * (t.dim() - 1)))
    offs = (torch.arange(m) * n).repeat_interleave(n)[:, None]
    nbr = torch.where(tile(nbr_t) < 0, tile(nbr_t), tile(nbr_t) + offs)
    big = t_bs.BlockSystem(tile(sys_t.D), tile(sys_t.Bt), tile(sys_t.C), sys_t.Hg * m, tile(sys_t.g_p), sys_t.g_g * m)
    return big, nbr


def test_repeated_system_is_the_copies_solve():
    """On the CPU: the repeated system that the strided-kernel case below
    builds is positive definite and the plain PCG solves it."""
    _, _, _, sys_t, nbr_t, _, lam = pcg_problem_cpu()
    big, nbr = _repeated(sys_t, nbr_t, 3)
    b = -t_bs.flat_gradient(big)
    x, k = block_pcg.pcg_block_system_plain(big, nbr, b, lam, 200, 1e-6)
    res = t_bs.block_matvec(big, nbr, x, lam) - b
    assert 1 < k < 200
    assert float(torch.linalg.norm(res)) <= 1e-4 * float(torch.linalg.norm(b))


@pytest.mark.cuda
def test_cuda_pcg_kernel_strided_beyond_the_resident_limit(pcg_problem):
    """More points than the co-resident grid has warps: the strided kernel
    (grid-stride over points, state in the workspace) against the plain
    loop, and 20 calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    _, _, _, sys_t, nbr_t, _, lam = pcg_problem
    lib = block_pcg._load()
    n, K = nbr_t.shape
    m = 1
    while lib.tids_pcg_resident(n * m, K) != 0:
        m += 1
    big, nbr = _repeated(sys_t, nbr_t, m)
    big, nbr = t_bs.BlockSystem(*(a.cuda() for a in big)), nbr.cuda()
    b = -t_bs.flat_gradient(big)
    assert lib.tids_pcg_grid(n * m, K) * 8 < n * m
    x, k = block_pcg.pcg_block_system_cuda(big, nbr, b, lam, 64, 1e-2)
    xp, kp = block_pcg.pcg_block_system_plain(big, nbr, b, lam, 64, 1e-2)
    assert int(k) == kp
    assert rel(x.cpu(), xp.cpu()) < 1e-4
    for _ in range(20):
        xr, kr = block_pcg.pcg_block_system_cuda(big, nbr, b, lam, 64, 1e-2)
        assert torch.equal(xr, x) and int(kr) == int(k)
