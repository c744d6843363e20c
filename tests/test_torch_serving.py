"""Parity of the port's serving path with the JAX package, on the CPU:
``ops/lm.lm_optimize_flat_batched``, ``models/deformable.solve_pairs``
(dense and block branches), ``solve_pairs_pipelined``, the batch-aware
backend dispatch and the serving fixture (``harness/serving.py``).

Tolerances are stated per test; they are the JAX package's own tests' (the
flat driver against the sequential one, ``tests/test_lm.py:101-150``) or
``test_solve_pair_matches_jax``'s (n_accepted equal, cost 1e-4 relative,
points 1e-6 m after 8 iterations, before the schedules can part on f32
noise).

Run as a script, it prints the JAX package's CPU values of the serving
fixtures that ``chip_smoke.py`` holds the card to: JAX's frozen rotations
at the vertices that the draw leaves free (``serving.free_vertices``),
which the card's fixture pins, and the costs (``--port``: the port's CPU
values on the pinned fixtures beside them, and their spread;
``--mutants``: how many block pairs a deliberately weakened PCG puts
outside chip_smoke.py's limit of 1e-2 from JAX after 3 iterations):

    JAX_PLATFORMS=cpu python tests/test_torch_serving.py [--port] [--mutants]
"""

import os
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_problems import CAM, deforming_problem, jax_problem, torch_problem
from triangulation_in_deformable_scenes_torch.harness import serving
from triangulation_in_deformable_scenes_torch.models import deformable as t_def
from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc
from triangulation_in_deformable_scenes_torch.ops import lm as t_lm
from triangulation_in_deformable_scenes_tpu.models import deformable as j_def
from triangulation_in_deformable_scenes_tpu.ops import lm as j_lm

torch.set_num_threads(1)

# LM iterations after which the serving fixtures' runs are still tied (the
# script mode's *_TIED values; chip_smoke.py's SERVING_TIED_ITERS).
TIED_ITERATIONS = 1


def _flat_problem():
    """tests/test_lm.py:101-150: 4 nonlinear least-squares problems of
    different conditioning, m=20 residuals, d=6 unknowns, default_rng(5)."""
    rng = np.random.default_rng(5)
    batch, m, d = 4, 20, 6
    As = (rng.normal(size=(batch, m, d)) * (10.0 ** rng.uniform(-1, 1, size=(batch, 1, 1)))).astype(np.float32)
    bs = rng.normal(size=(batch, m)).astype(np.float32)
    return As, bs, batch, d


def _port_flat(As, bs, batch, d, n_iterations):
    At, bt = torch.as_tensor(As), torch.as_tensor(bs)

    def resid(i, x):
        # 1-d sums, not 0-d scalars (the forward-mode AD note in ops/lie.py).
        return At[i] @ x + 0.3 * torch.sin(x).sum(dim=0, keepdim=True) - bt[i]

    def cost_one(i, x):
        r = resid(i, x)
        return torch.dot(r, r)

    def build_one(i, x):
        J = torch.func.jacfwd(lambda y: resid(i, y))(x)
        r = resid(i, x)
        return J.T @ J, J.T @ r

    def make_step_b(xb):
        Hg = [build_one(i, xb[i]) for i in range(batch)]
        H = torch.stack([h for h, _ in Hg])
        g = torch.stack([gg for _, gg in Hg])
        diag_max = torch.stack([torch.max(torch.diagonal(h)) for h, _ in Hg])
        return (lambda lam_b: t_lm.solve_damped_cholesky_batched(H, g, lam_b)), g, diag_max

    res_b = t_lm.lm_optimize_flat_batched(
        make_step_b, lambda xb: torch.stack([cost_one(i, xb[i]) for i in range(batch)]),
        lambda x, dd: x + dd, torch.zeros(batch, d), batch, n_iterations,
    )
    seqs = []
    for i in range(batch):
        def make_step(x, i=i):
            H, g = build_one(i, x)
            return (lambda l: t_lm.solve_damped_cholesky(H, g, l)), g, torch.max(torch.diagonal(H))

        seqs.append(t_lm.lm_optimize_general(make_step, lambda x, i=i: cost_one(i, x), lambda x, dd: x + dd,
                                             torch.zeros(d), n_iterations))
    return res_b, seqs


def _jax_flat(As, bs, batch, d, n_iterations):
    Aj, bj = jnp.asarray(As), jnp.asarray(bs)

    def resid(A, b, x):
        return A @ x + 0.3 * jnp.sin(x).sum() - b

    def build_one(A, b, x):
        J = jax.jacfwd(lambda y: resid(A, b, y))(x)
        r = resid(A, b, x)
        return J.T @ J, J.T @ r

    def make_step_b(xb):
        Hg = [build_one(Aj[i], bj[i], xb[i]) for i in range(batch)]
        H = jnp.stack([h for h, _ in Hg])
        g = jnp.stack([gg for _, gg in Hg])
        solve_b = jax.vmap(j_lm.solve_damped_cholesky)
        return (lambda lam_b: solve_b(H, g, lam_b)), g, jnp.max(jnp.diagonal(H, axis1=-2, axis2=-1), axis=-1)

    return j_lm.lm_optimize_flat_batched(
        make_step_b,
        lambda xb: jnp.stack([jnp.dot(resid(Aj[i], bj[i], xb[i]), resid(Aj[i], bj[i], xb[i])) for i in range(batch)]),
        lambda x, dd: x + dd, jnp.zeros((batch, d)), batch, n_iterations,
    )


def _hold(res_b, i, want_acc, want_cost, want_lam, want_state):
    """tests/test_lm.py:146-150's limits for member i."""
    assert int(res_b.n_accepted[i]) == want_acc, i
    np.testing.assert_allclose(float(res_b.cost[i]), want_cost, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(res_b.lam[i]), want_lam, rtol=1e-4)
    np.testing.assert_allclose(res_b.state[i].numpy(), want_state, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("n_iterations", [3, 10])
def test_flat_batched_matches_sequential_and_jax(n_iterations):
    """The port's flat driver takes each problem's sequential schedule (its
    own ``lm_optimize_general``): n_accepted equal, cost within 1e-5
    relative (1e-8 absolute), lambda 1e-4, state 1e-4 relative (1e-7
    absolute), the limits of tests/test_lm.py:146-150; over 10 iterations
    the problems' trial counts differ, so some steps reject (over 3 none
    does). Against JAX's flat driver the same
    limits hold through 3 iterations. After that problems 0 and 3 sit at the
    f32 noise floor (their costs move by < 1e-7 relative, which the two
    packages' last bits decide): whether a further step is accepted is the
    rounding's, and JAX takes 2 and 1 more steps with lambdas orders of
    magnitude apart, as ``test_solve_pair_matches_jax`` notes at 25
    iterations. So at 10 iterations the cost alone is held to JAX's."""
    As, bs, batch, d = _flat_problem()
    res_b, seqs = _port_flat(As, bs, batch, d, n_iterations)
    rj = _jax_flat(As, bs, batch, d, n_iterations)
    assert res_b.n_accepted.shape == (batch,)
    assert res_b.n_solves > int(res_b.n_accepted.max()) or n_iterations == 3
    for i in range(batch):
        _hold(res_b, i, seqs[i].n_accepted, float(seqs[i].cost), float(seqs[i].lam), seqs[i].state.numpy())
        if n_iterations == 3:
            _hold(res_b, i, int(rj.n_accepted[i]), float(rj.cost[i]), float(rj.lam[i]), np.asarray(rj.state[i]))
        else:
            np.testing.assert_allclose(float(res_b.cost[i]), float(rj.cost[i]), rtol=1e-5, atol=1e-8)


def _stack_np(trees):
    return {k: np.stack([np.asarray(getattr(t, k)) for t in trees]) for k in trees[0]._fields}


def _pairs(seeds, n_side=5):
    """Both packages' (data, state, hyper) for deforming_problem at each
    seed (tests/test_deformable.py:12 make_problem)."""
    pbs = [deforming_problem(n_side=n_side, seed=s) for s in seeds]
    return pbs, [jax_problem(pb) for pb in pbs], [torch_problem(pb) for pb in pbs]


def _batched(jaxs, torchs, hyper_batched):
    jd = j_def.PairData(**{k: jnp.asarray(v) for k, v in _stack_np([j[0] for j in jaxs]).items()})
    js = j_def.PairState(**{k: jnp.asarray(v) for k, v in _stack_np([j[1] for j in jaxs]).items()})
    td, ts = t_lm.stack([t[0] for t in torchs]), t_lm.stack([t[1] for t in torchs])
    jh, th = jaxs[0][2], torchs[0][2]
    if hyper_batched:
        # A different ARAP weight per pair; every field carries the pair axis.
        B = len(jaxs)
        vals = {k: np.full(B, float(np.asarray(getattr(jh, k))), np.float32) for k in j_def.Hyper._fields}
        vals["arap_w"] = (1e-4 * (1.0 + np.arange(B))).astype(np.float32)
        jh = j_def.Hyper(**{k: jnp.asarray(v) for k, v in vals.items()})
        th = t_def.Hyper(**{k: torch.as_tensor(v) for k, v in vals.items()})
    return (jd, js, jh), (td, ts, th)


def test_convert_takes_the_stacked_batch():
    """convert.pair_*_from_numpy carry a leading pair axis over: JAX's
    stacked PairData/PairState become the port's stacked batch (int64
    indices, bool masks, f32 values), equal to stacking the port's pairs."""
    from triangulation_in_deformable_scenes_torch import convert

    _, jaxs, torchs = _pairs([0, 1], n_side=4)
    nd, ns = _stack_np([j[0] for j in jaxs]), _stack_np([j[1] for j in jaxs])
    td, ts = convert.pair_data_from_numpy(nd, device="cpu"), convert.pair_state_from_numpy(ns, device="cpu")
    want_d, want_s = t_lm.stack([t[0] for t in torchs]), t_lm.stack([t[1] for t in torchs])
    assert td.nbr.dtype == torch.int64 and td.valid.dtype == torch.bool and td.kp1.dtype == torch.float32
    for got, want in ((td, want_d), (ts, want_s)):
        for name, a, b in zip(got._fields, got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-6), name


@pytest.mark.parametrize("hyper_batched", [False, True], ids=["shared_hyper", "batched_hyper"])
def test_solve_pairs_dense_matches_jax(hyper_batched):
    """solve_pairs on make_problem seeds 0 and 1 (as tests/test_deformable.py:183),
    8 iterations, dense branch: per pair the same n_accepted, the cost within
    1e-4 relative and the points within 1e-6 m of JAX's solve_pairs."""
    _, jaxs, torchs = _pairs([0, 1])
    (jd, js, jh), (td, ts, th) = _batched(jaxs, torchs, hyper_batched)
    assert t_def.use_dense_backend(td.kp1.shape[1], td.nbr.shape[-1], 2)
    rt = t_def.solve_pairs("KB8", td, th, ts, 8)
    rj = j_def.solve_pairs("KB8", jd, jh, js, 8)
    for i in range(2):
        assert int(rt.n_accepted[i]) == int(rj.n_accepted[i]) == 8, i
        assert abs(float(rt.cost[i]) - float(rj.cost[i])) <= 1e-4 * abs(float(rj.cost[i])), i
        assert float(rt.cost[i]) < 0.1 * float(rt.initial_cost[i])
        for a, b in ((rt.state.p1[i], rj.state.p1[i]), (rt.state.p2[i], rj.state.p2[i])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_solve_pairs_block_branch_matches_jax(monkeypatch):
    """DENSE_J_BUDGET_BYTES patched to 1 in both packages (as
    tests/test_block_system.py:79), so the batch runs on the block backend:
    the costs are finite, descend, and lie within 1e-2 of JAX's after 3
    iterations (the block PCG stops at rtol 1e-2)."""
    monkeypatch.setattr(j_def, "DENSE_J_BUDGET_BYTES", 1)
    monkeypatch.setattr(t_def, "DENSE_J_BUDGET_BYTES", 1)
    _, jaxs, torchs = _pairs([0, 0], n_side=4)
    (jd, js, jh), (td, ts, th) = _batched(jaxs, torchs, False)
    assert not t_def.use_dense_backend(td.kp1.shape[1], td.nbr.shape[-1], 2)
    rt = t_def.solve_pairs("KB8", td, th, ts, 3)
    rj = j_def.solve_pairs("KB8", jd, jh, js, 3)
    costs = rt.cost.numpy()
    assert np.all(np.isfinite(costs))
    assert np.all(costs <= rt.initial_cost.numpy() * 1.01)
    np.testing.assert_allclose(costs, np.asarray(rj.cost), rtol=1e-2)
    np.testing.assert_array_equal(rt.n_accepted.numpy(), np.asarray(rj.n_accepted))


def test_solve_pairs_pipelined_equals_solve_pair():
    """The per-pair scheduler is solve_pair pair by pair: the same bits."""
    _, _, torchs = _pairs([0, 1], n_side=4)
    th = torchs[0][2]
    got = t_def.solve_pairs_pipelined("KB8", [t[0] for t in torchs], th, [t[1] for t in torchs], 5)
    for (td, ts, _), r in zip(torchs, got):
        want = t_def.solve_pair("KB8", td, th, ts, 5)
        assert r.n_accepted == want.n_accepted and r.n_solves == want.n_solves
        assert torch.equal(r.cost, want.cost)
        for a, b in zip(r.state, want.state):
            assert torch.equal(a, b)


def test_solve_pairs_takes_each_pairs_solve_pair_schedule():
    """Flat-batched against per-pair solve_pair on the port alone (the check
    chip_smoke.py makes on the card): the same n_accepted, the cost within
    1e-5 relative."""
    _, _, torchs = _pairs([0, 1], n_side=4)
    td, ts = t_lm.stack([t[0] for t in torchs]), t_lm.stack([t[1] for t in torchs])
    th = torchs[0][2]
    rb = t_def.solve_pairs("KB8", td, th, ts, 8)
    for i, (d, s, _) in enumerate(torchs):
        r = t_def.solve_pair("KB8", d, th, s, 8)
        assert int(rb.n_accepted[i]) == r.n_accepted
        assert abs(float(rb.cost[i]) - float(r.cost)) <= 1e-5 * abs(float(r.cost))


@pytest.mark.parametrize("n_points,pair,iterations", [
    pytest.param(serving.POINTS, 1, serving.ITERATIONS, id="1"),
    pytest.param(serving.POINTS, 8, serving.ITERATIONS, id="8"),
    pytest.param(serving.BLOCK_POINTS, 10, serving.BLOCK_ITERATIONS, id="block-10"),
])
def test_free_rotations_are_the_gap_to_jax(monkeypatch, n_points, pair, iterations):
    """Some vertices of the serving fixtures keep one weighted mesh edge
    (``serving.free_vertices``): any frozen rotation about that edge fits,
    and each package's SVD picks its own (dense pairs 1 and 8 unpinned end
    1.3e-2 and 2.2e-2 from JAX after 25 iterations, where every pair
    without one ends within 7.5e-5). Pinned to JAX's rotations at exactly
    those vertices, as chip_smoke.py pins the card's fixture, the port's run
    lands within 1e-4 of JAX's with the same n_accepted: the gap is the
    free rotations, not the port's arithmetic. Block pair 10 (9 free
    vertices) runs on the block backend in both packages, the budget patched
    to 1 as in test_solve_pairs_block_branch_matches_jax."""
    datas, states, _, _, jh = _jax_fixture(n_points)
    free = serving.serving_batch(n_points, device="cpu").free
    assert free[pair] and (n_points != serving.POINTS or not free[0])
    fx = serving.serving_batch(n_points, device="cpu", rotations=_jax_free_rotations(datas, free))
    if n_points == serving.POINTS:
        rj = j_def.solve_pair("KB8", datas[pair], jh, states[pair], iterations)
        rt = t_def.solve_pair("KB8", fx.datas[pair], fx.hyper, fx.states[pair], iterations)
        acc_j, acc_t, cost_j, cost_t = int(rj.n_accepted), rt.n_accepted, float(rj.cost), float(rt.cost)
    else:
        monkeypatch.setattr(j_def, "DENSE_J_BUDGET_BYTES", 1)
        monkeypatch.setattr(t_def, "DENSE_J_BUDGET_BYTES", 1)
        one = lambda x: jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], x)
        rj = j_def.solve_pairs("KB8", one(datas[pair]), jh, one(states[pair]), iterations)
        rt = t_def.solve_pairs("KB8", t_lm.stack([fx.datas[pair]]), fx.hyper, t_lm.stack([fx.states[pair]]),
                               iterations)
        acc_j, acc_t = int(rj.n_accepted[0]), int(rt.n_accepted[0])
        cost_j, cost_t = float(rj.cost[0]), float(rt.cost[0])
    assert acc_t == acc_j == iterations
    assert abs(cost_t / cost_j - 1) < 1e-4


@pytest.mark.parametrize("n,K,batch", [(128, 32, 16), (240, 32, 1), (240, 32, 16), (680, 32, 1),
                                       (680, 32, 16), (680, 32, 4), (500, 16, 8), (1000, 32, 1),
                                       (682, 32, 1), (16, 8, 2)])
def test_use_dense_backend_matches_jax(n, K, batch):
    assert t_def.use_dense_backend(n, K, batch) == j_def.use_dense_backend(n, K, batch)


@pytest.mark.parametrize("n_points", [serving.POINTS, serving.BLOCK_POINTS])
def test_serving_fixture_draws_bench_pairs(n_points):
    """harness/serving draws bench.py:687-707's pairs: the same numpy draws,
    the same K filter, the same meshes (bench.py meshes with the default
    backend; the fixture with scipy's, the same triangulation for points in
    general position) and cot weights. The frozen rotations agree within
    5e-5 where the weighted covariance is well conditioned (its second
    singular value over 1e-2 of the first: an f32 fit is good to about
    eps x 100; 1.2e-5 read at 680 points); a vertex with a single neighbour of
    non-zero cot weight (a rank-1 weighted covariance; 8 of the 2,048 at 128
    points, in 6 pairs) may turn freely about that edge, and the two packages' f32 SVDs
    pick different members. Its edge energies see only the aligned
    direction, so the ARAP energies agree within 1e-5 of the largest and the
    initial cost within 1e-6 relative (1.1e-6 and 2e-7 read)."""
    fx = serving.serving_batch(n_points, device="cpu")
    jh = j_def.Hyper(**{k: jnp.asarray(v, jnp.float32) for k, v in serving.HYPER.items()})
    rng = np.random.default_rng(0)
    kept, datas, draws = [], [], []
    for i in range(serving.BATCH):
        p1 = rng.normal(size=(n_points, 3)) * 0.05 + [0, 0, 0.2]
        p2 = p1 + rng.normal(scale=0.005, size=(n_points, 3))
        kp = rng.uniform(100, 600, size=(n_points, 2))
        d = j_def.make_pair_data(
            kp1=kp, kp2=kp, depth1=p1[:, 2], depth2=p2[:, 2], valid=np.ones(n_points, bool),
            cam_params=np.array([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0]),
            T1w=(np.eye(3), np.zeros(3)), T2w=(np.eye(3), np.zeros(3)), p1=p1, p2=p2,
            scale_priors=(1.0, 1e6, 1.0, 1e6), degree_bucket=32,
        )
        if d.nbr.shape[1] != 32:
            continue
        kept.append(i)
        datas.append(d)
        draws.append((p1, p2))
    assert fx.kept == kept and len(kept) == serving.BATCH
    assert fx.data.kp1.shape == (len(kept), n_points, 2)
    n_free = 0
    for td, ts, jd, (p1, p2), fv in zip(fx.datas, fx.states, datas, draws, fx.free):
        np.testing.assert_array_equal(td.nbr.numpy(), np.asarray(jd.nbr))
        np.testing.assert_allclose(td.wcot.numpy(), np.asarray(jd.wcot), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(td.kp1.numpy(), np.asarray(jd.kp1))
        nbr, w = np.asarray(jd.nbr), np.asarray(jd.wcot, np.float64)
        j = np.maximum(nbr, 0)
        e1, e2 = p1[j] - p1[:, None], p2[j] - p2[:, None]
        S = np.einsum("nk,nka,nkb->nab", w * (nbr >= 0), e1, e2)
        sv = np.linalg.svd(S, compute_uv=False)
        assert fv == np.flatnonzero(sv[:, 1] <= 1e-9 * sv[:, 0]).tolist()
        n_free += len(fv)
        well = sv[:, 1] > 1e-2 * sv[:, 0]
        np.testing.assert_allclose(td.Ri.numpy()[well], np.asarray(jd.Ri)[well], atol=5e-5)
        js = j_def.PairState(p1=jnp.asarray(p1, jnp.float32), p2=jnp.asarray(p2, jnp.float32),
                             s1=jnp.asarray(1.0, jnp.float32), s2=jnp.asarray(1.0, jnp.float32),
                             Rg=jnp.eye(3, dtype=jnp.float32), tg=jnp.zeros(3, jnp.float32))
        Ej, Et = np.asarray(j_def._arap_energies(jd, js)), t_def._arap_energies(td, ts).numpy()
        assert np.abs(Et - Ej).max() <= 1e-5 * np.abs(Ej).max()
        cj, ct = float(j_def.robust_cost("KB8", jd, jh, js)), float(t_def.robust_cost("KB8", td, fx.hyper, ts))
        assert abs(ct - cj) <= 1e-6 * abs(cj)
    assert n_free <= 0.01 * len(kept) * n_points
    assert float(fx.hyper.arap_w) == pytest.approx(1e-4)


def test_serving_fixture_without_device_raises_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.serving_batch(8, batch=1)


def test_batched_solve_wrapper_rejects_cpu_tensors():
    H = torch.eye(4).expand(2, 4, 4).contiguous()
    with pytest.raises(ValueError):
        dc.damped_solve_batched_cuda(H, torch.ones(2, 4), torch.ones(2))


def test_batched_plain_is_the_single_plain_per_system():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, 40, 40)).astype(np.float32)
    H = torch.as_tensor(A @ A.transpose(0, 2, 1) + 40 * np.eye(40, dtype=np.float32))
    g = torch.as_tensor(rng.normal(size=(3, 40)).astype(np.float32))
    lam = torch.tensor([1e-3, 1.0, 10.0])
    x = t_lm.solve_damped_cholesky_batched(H, g, lam)
    for k in range(3):
        assert torch.equal(x[k], dc.solve_damped_cholesky_plain(H[k], g[k], lam[k]))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("B,dim", [(1, 6), (4, 776), (16, 776), (16, 1448)])
def test_cuda_batched_kernel_equals_single_launches(B, dim):
    """Every member bit for bit the single launch's; one launch per batch; a
    non-PD member non-finite alone."""
    _cuda()
    from test_torch_damped_solve import make_system

    systems = [make_system(dim, seed=k) for k in range(B)]
    H = torch.as_tensor(np.stack([s[0] for s in systems]), device="cuda")
    g = torch.as_tensor(np.stack([s[1] for s in systems]), device="cuda")
    lam = torch.tensor([s[2] for s in systems], device="cuda")
    before = dc.LAUNCHES_BATCHED
    x = dc.damped_solve_batched_cuda(H, g, lam)
    assert dc.LAUNCHES_BATCHED == before + 1
    for k in range(B):
        assert torch.equal(x[k], dc.damped_solve_cuda(H[k], g[k], lam[k]))
    Hbad = H.clone()
    Hbad[B // 2, dim // 2, dim // 2] = -1e30
    finite = torch.isfinite(dc.damped_solve_batched_cuda(Hbad, g, torch.zeros(B, device="cuda"))).all(1)
    assert finite.tolist() == [k != B // 2 for k in range(B)]


@pytest.mark.cuda
def test_cuda_solve_pairs_one_batched_launch_per_step():
    _cuda()
    fx = serving.serving_batch(serving.POINTS, batch=4)
    before = dc.LAUNCHES_BATCHED
    res = t_def.solve_pairs("KB8", fx.data, fx.hyper, fx.state, 5)
    assert dc.LAUNCHES_BATCHED - before == res.n_solves
    for i, (d, s) in enumerate(zip(fx.datas, fx.states)):
        r = t_def.solve_pair("KB8", d, fx.hyper, s, 5)
        assert int(res.n_accepted[i]) == r.n_accepted
        assert abs(float(res.cost[i]) - float(r.cost)) <= 1e-5 * abs(float(r.cost))


# ---------------------------------------------------------------------------
# Script mode: the serving fixtures' JAX values for chip_smoke.py.
# ---------------------------------------------------------------------------


def _jax_fixture(n_points):
    """The JAX package's PairData/PairState of harness/serving's draws, the
    same K filter and mesh backend, stacked; and the shared Hyper."""
    datas, states = [], []
    for p1, p2, kp in serving.draw_pairs(n_points):
        d = j_def.make_pair_data(
            kp1=kp, kp2=kp, depth1=p1[:, 2], depth2=p2[:, 2], valid=np.ones(n_points, bool),
            cam_params=np.asarray(serving.CAM), T1w=(np.eye(3), np.zeros(3)), T2w=(np.eye(3), np.zeros(3)),
            p1=p1, p2=p2, mesh_backend=serving.MESH_BACKEND, scale_priors=serving.SCALE_PRIORS,
            degree_bucket=serving.DEGREE_BUCKET,
        )
        if d.nbr.shape[1] != serving.DEGREE_BUCKET:
            continue
        datas.append(d)
        states.append(j_def.PairState(p1=jnp.asarray(p1, jnp.float32), p2=jnp.asarray(p2, jnp.float32),
                                      s1=jnp.asarray(1.0, jnp.float32), s2=jnp.asarray(1.0, jnp.float32),
                                      Rg=jnp.eye(3, dtype=jnp.float32), tg=jnp.zeros(3, jnp.float32)))
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    hyper = j_def.Hyper(**{k: jnp.asarray(v, jnp.float32) for k, v in serving.HYPER.items()})
    return datas, states, stack(datas), stack(states), hyper


def _jax_free_rotations(datas, free):
    """JAX's frozen rotations at each pair's free vertices, in the form
    ``serving.serving_batch(rotations=...)`` takes."""
    return {i: {v: [float(a) for a in np.asarray(datas[i].Ri)[v].reshape(-1)] for v in fv}
            for i, fv in enumerate(free) if fv}


def _weak_pcg_mutants(n_points, rotations, jax_cost):
    """The block branch with the port's plain PCG weakened (capped at 8
    iterations, stopped at rtol 0.1, steps scaled by 0.99 and 0.9): per
    mutant, the pairs whose cost after BLOCK_ITERATIONS lies over 1e-2 (the
    card's TIED_RTOL) from JAX's."""
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    fx = serving.serving_batch(n_points, device="cpu", rotations=rotations)
    plain = block_pcg.pcg_block_system_plain
    for name, cap, rtol, scale in (("cap 8", 8, None, 1.0), ("rtol 0.1", None, 0.1, 1.0),
                                   ("step x 0.99", None, None, 0.99), ("step x 0.9", None, None, 0.9)):
        def weak(sys_, nbr, b, lam, iters, r, cap=cap, rtol=rtol, scale=scale):
            x, k = plain(sys_, nbr, b, lam, cap or iters, rtol or r)
            return x * scale, k
        block_pcg.pcg_block_system_plain = weak
        try:
            rt = t_def.solve_pairs("KB8", fx.data, fx.hyper, fx.state, serving.BLOCK_ITERATIONS)
        finally:
            block_pcg.pcg_block_system_plain = plain
        rel = np.abs(rt.cost.numpy().astype(np.float64) / np.asarray(jax_cost) - 1)
        print(f"# mutant {name}: {int((rel > 1e-2).sum())} of {len(rel)} block pairs over 1e-2 from JAX "
              f"(largest {rel.max():.3e})")


def _main(argv):
    port = "--port" in argv
    for label, n, iters, pipelined in (("DENSE", serving.POINTS, serving.ITERATIONS, True),
                                       ("BLOCK", serving.BLOCK_POINTS, serving.BLOCK_ITERATIONS, False)):
        datas, states, bd, bs, hyper = _jax_fixture(n)
        rotations = _jax_free_rotations(datas, serving.serving_batch(n, device="cpu").free)
        print(f"JAX_SERVING_{label}_FREE_RI = {{")
        for i, rs in rotations.items():
            print(f"    {i}: {rs!r},")
        print("}")
        fx = serving.serving_batch(n, device="cpu", rotations=rotations) if port else None
        # After TIED_ITERATIONS the runs are still tied; the full budget.
        for suffix, it in (("_TIED", TIED_ITERATIONS), ("", iters)):
            rj = j_def.solve_pairs("KB8", bd, hyper, bs, it)
            cost = [float(c) for c in np.asarray(rj.cost)]
            print(f"JAX_SERVING_{label}{suffix}_COST = {cost!r}")
            print(f"JAX_SERVING_{label}{suffix}_N_ACCEPTED = {[int(a) for a in np.asarray(rj.n_accepted)]!r}")
            if port:
                rt = t_def.solve_pairs("KB8", fx.data, fx.hyper, fx.state, it)
                tc = rt.cost.numpy().astype(np.float64)
                print(f"PORT_CPU_SERVING_{label}{suffix}_COST = {tc.tolist()!r}")
                print(f"# {label}{suffix}: port CPU (JAX's free rotations pinned) vs JAX, max relative cost "
                      f"spread {np.abs(tc / np.asarray(cost) - 1).max():.3e}; n_accepted equal: "
                      f"{rt.n_accepted.tolist() == [int(a) for a in np.asarray(rj.n_accepted)]}")
        if "--mutants" in argv and not pipelined:
            _weak_pcg_mutants(n, rotations, cost)
        if pipelined:
            rp = j_def.solve_pairs_pipelined("KB8", datas, hyper, states, iters)
            print(f"JAX_SERVING_{label}_PIPELINED_COST = {[float(r.cost) for r in rp]!r}")
            print(f"JAX_SERVING_{label}_PIPELINED_N_ACCEPTED = {[int(r.n_accepted) for r in rp]!r}")


if __name__ == "__main__":
    _main(sys.argv[1:])
