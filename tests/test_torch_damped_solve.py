"""The damped equilibrated Cholesky solve of the port against the JAX package.

On the CPU the port's ``solve_damped_cholesky`` is the plain version
(``solve_damped_cholesky_plain``); it is held against the JAX contract
``ops/lm.solve_damped_cholesky`` and against the Pallas kernel
``damped_solve_pallas`` run in interpret mode, as tests/test_pallas_cholesky.py
runs it. The CUDA kernel itself is compared with the plain version only on a
card (marked ``cuda``; it skips here).

Tolerance: relative error < 1e-5 of max|x|, the bound tests/test_pallas_cholesky.py
asks of the Pallas kernel (the systems have condition ~5 after equilibration,
so f32 solves agree to a few ulps times the dimension).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc
from triangulation_in_deformable_scenes_torch.ops import lm as t_lm
from triangulation_in_deformable_scenes_tpu.ops.lm import solve_damped_cholesky as jax_solve
from triangulation_in_deformable_scenes_tpu.ops.pallas_cholesky import damped_solve_pallas

torch.set_num_threads(1)


def make_system(dim, seed=0):
    """SPD H with diagonal scales 1e-3..1e5 (the equilibration must engage)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(dim, dim)).astype(np.float32)
    H = A @ A.T + dim * np.eye(dim, dtype=np.float32)
    d = 10.0 ** rng.uniform(-3, 5, size=dim).astype(np.float32)
    H = (H * d[:, None] * d[None, :]).astype(np.float32)
    g = (rng.normal(size=dim) * d).astype(np.float32)
    lam = float(H.diagonal().max()) * 1e-6
    return H, g, lam


def make_refinement_system(dim, seed=0):
    """H whose upper triangle differs from its lower one by a relative 1e-3
    (condition ~10, diagonal scales 1e-3..1e5). The
    factorization reads only the lower triangle and the refinement residual
    the whole matrix, so only the refinement step moves x from the solution
    of the lower-triangle system to that of H."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    C = (Q * np.logspace(0, -1, dim)) @ Q.T
    C = 0.5 * (C + C.T) + np.triu(rng.normal(size=(dim, dim)), 1) * (1e-3 / np.sqrt(dim))
    c = 1.0 / np.sqrt(np.diag(C))
    d = 10.0 ** rng.uniform(-3, 5, size=dim)
    H = (C * (c * d)[:, None] * (c * d)[None, :]).astype(np.float32)
    g = (rng.normal(size=dim) * d).astype(np.float32)
    return H, g


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("dim", [300, 728])
def test_plain_matches_jax_contract(dim):
    H, g, lam = make_system(dim)
    ref = np.asarray(jax_solve(jnp.asarray(H), jnp.asarray(g), lam))
    got = t_lm.solve_damped_cholesky(torch.as_tensor(H), torch.as_tensor(g), lam)
    assert rel_err(got, ref) < 1e-5


@pytest.mark.parametrize("dim", [300, 728])
def test_plain_matches_pallas_interpret(dim):
    H, g, lam = make_system(dim, seed=1)
    ref = np.asarray(damped_solve_pallas(jnp.asarray(H), jnp.asarray(g), lam, interpret=True))
    got = dc.solve_damped_cholesky_plain(torch.as_tensor(H), torch.as_tensor(g), lam)
    assert rel_err(got, ref) < 1e-5


def test_refinement_step_reads_the_whole_matrix():
    """The refined solve lands near the f64 solution of the whole H, the
    unrefined one (lower triangle only) a hundred times farther; the plain
    version and the JAX contract agree. Limit 1e-4 of max|x|: the refined
    error is ~(condition x asymmetry)^2 ~ 1e-5, the unrefined ~1e-2."""
    H, g = make_refinement_system(300)
    want = -np.linalg.solve(H.astype(np.float64), g.astype(np.float64))
    got = dc.solve_damped_cholesky_plain(torch.as_tensor(H), torch.as_tensor(g), 0.0)
    ref = np.asarray(jax_solve(jnp.asarray(H), jnp.asarray(g), 0.0))
    Hl = np.tril(H) + np.tril(H, -1).T
    unrefined = -np.linalg.solve(Hl.astype(np.float64), g.astype(np.float64))
    assert rel_err(got, want) < 1e-4
    assert rel_err(ref, want) < 1e-4
    assert rel_err(unrefined, want) > 1e-3
    assert rel_err(got, ref) < 1e-5


def test_lam_as_device_scalar_tensor():
    """The LM loop passes lambda as a 0-d tensor; same answer as a float."""
    H, g, lam = make_system(64, seed=2)
    a = t_lm.solve_damped_cholesky(torch.as_tensor(H), torch.as_tensor(g), lam)
    b = t_lm.solve_damped_cholesky(torch.as_tensor(H), torch.as_tensor(g), torch.tensor(lam))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["negative_pivot", "zero_matrix"])
def test_non_pd_gives_non_finite_without_raising(kind):
    """A non-PD damped system yields non-finite output (LM then rejects the
    trial, ``lm.py:110``), as jax's cho_factor does -- and does not raise."""
    dim = 48
    rng = np.random.default_rng(3)
    if kind == "negative_pivot":
        A = rng.normal(size=(dim, dim)).astype(np.float32)
        H = A @ A.T + dim * np.eye(dim, dtype=np.float32)
        H[dim // 2, dim // 2] = -5.0 * dim
    else:
        H = np.zeros((dim, dim), np.float32)
    g = rng.normal(size=dim).astype(np.float32)
    out = t_lm.solve_damped_cholesky(torch.as_tensor(H), torch.as_tensor(g), 0.0)
    assert not torch.isfinite(out).all()
    jout = np.asarray(jax_solve(jnp.asarray(H), jnp.asarray(g), 0.0))
    assert not np.isfinite(jout).all()


def test_wrapper_rejects_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: a CPU tensor raises
    instead of falling back."""
    H, g, lam = make_system(32)
    with pytest.raises(ValueError):
        dc.damped_solve_cuda(torch.as_tensor(H), torch.as_tensor(g), lam)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 31, 32, 33, 300, 377, 728, 746, 1000, 1448, 2591])
def test_cuda_kernel_matches_plain(dim):
    """Tile edges (the dim is padded to a multiple of 32) and the main paths'
    dims; a non-PD system gives non-finite output, without a hang or a raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    H, g, lam = make_system(dim, seed=4)
    Hc, gc = torch.as_tensor(H, device="cuda"), torch.as_tensor(g, device="cuda")
    before = dc.LAUNCHES
    got = t_lm.solve_damped_cholesky(Hc, gc, lam)
    torch.cuda.synchronize()
    assert dc.LAUNCHES == before + 1
    want = dc.solve_damped_cholesky_plain(Hc, gc, lam)
    assert rel_err(got.cpu(), want.cpu()) < 1e-5
    Hbad = Hc.clone()
    Hbad[dim // 2, dim // 2] = -1e30
    assert not torch.isfinite(dc.damped_solve_cuda(Hbad, gc, 0.0)).all()


@pytest.mark.cuda
def test_cuda_kernel_refines_against_the_whole_matrix():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    H, g = make_refinement_system(1448, seed=5)
    want = -np.linalg.solve(H.astype(np.float64), g.astype(np.float64))
    got = dc.damped_solve_cuda(torch.as_tensor(H, device="cuda"), torch.as_tensor(g, device="cuda"), 0.0)
    assert rel_err(got.cpu(), want) < 1e-4


@pytest.mark.cuda
def test_cuda_kernel_repeats_bit_identical():
    """No atomics and fixed summation orders: 20 calls on one input give the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    H, g, lam = make_system(1448, seed=6)
    Hc, gc = torch.as_tensor(H, device="cuda"), torch.as_tensor(g, device="cuda")
    first = dc.damped_solve_cuda(Hc, gc, lam)
    for _ in range(20):
        assert torch.equal(dc.damped_solve_cuda(Hc, gc, lam), first)
