"""Parity of the port's ``parallel/`` (``dist``, ``halo``) and
``deformable.assemble_diag`` with the JAX package, on the CPU.

The JAX side uses the conftest's 8 virtual devices (``jax.devices()[:S]``
for S shards); the port's ranks are subprocesses joined over gloo
(``parallel/launch.run_ranks``, a ``file://`` init method), one spawn per
world size running every case of that size (``_rank_job``), each rank
with a wall-clock limit. Limits, per test:

- the host plan (``morton_perm``, ``plan_halo``, ``pad_pair``,
  ``permute_data``): exactly JAX's, on ``tests/test_parallel.py``'s random
  pair at 25 (not divisible: padding), 64 and 1,000 points, S = 1, 2, 4, 8;
- one halo damped solve of a fixed system (to rtol 1e-4): JAX's
  ``shard_map`` PCG's iteration count, x within 1e-4 of max|x|, the global part bit-equal on
  every rank, three all-reduces a CG iteration;
- LM solves: after 1 iteration p1 within JAX's own one-step limit
  (rtol 5e-3, atol 1e-4, ``tests/test_parallel.py:71-73``) and the cost
  within 1e-3; after 5 the cost within 2e-2; costs bit-equal on every rank;
- pair-sharded serving: the port's unsharded batch within 1e-6 and JAX's
  pair-sharded run within ``tests/test_parallel.py:78-112``'s limits.

JAX's ``solve_pair_distributed`` on 2 or 4 virtual devices departs from its
own unsharded and 8-device runs on this pair (from the 2nd iteration it
accepts steps that raise the cost: 50730 -> 51350 -> ... -> 68383 at 2
devices, where 1 and 8 devices reach 653), so the port's baseline at world 2
is held to JAX's unsharded solve, which the 8-device run agrees with.

Run as a script, it prints the JAX package's CPU values at the scaled size
(``bench.py:889-950``, 16,384 points) that ``chip_smoke.py`` phase 20 holds
the card to:

    JAX_PLATFORMS=cpu python tests/test_torch_parallel.py
"""

import functools
import os
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

from triangulation_in_deformable_scenes_torch import convert
from triangulation_in_deformable_scenes_torch.models import block_system as t_bs
from triangulation_in_deformable_scenes_torch.models import deformable as t_def
from triangulation_in_deformable_scenes_torch.parallel import dist as t_dist
from triangulation_in_deformable_scenes_torch.parallel import halo as t_halo
from triangulation_in_deformable_scenes_torch.parallel import launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SOLVE = 250  # 250 % 4 == 2: the 4-rank halo solve pads
CG = 32
ITERS = (1, 5)
# The fixed system's damped solve runs to rtol 1e-4 (the LM path's 1e-2
# stops this pair's solve after one iteration).
PCG_RTOL = 1e-4
SERVING_PAIRS = 4
RANK_TIMEOUT_S = 240


def _jx():
    """The JAX side, imported on first use (the ranks import this module
    without JAX)."""
    import types

    import jax
    import jax.numpy as jnp

    from triangulation_in_deformable_scenes_tpu.models import block_system as j_bs
    from triangulation_in_deformable_scenes_tpu.models import deformable as j_def
    from triangulation_in_deformable_scenes_tpu.parallel import dist as j_dist
    from triangulation_in_deformable_scenes_tpu.parallel import halo as j_halo

    return types.SimpleNamespace(jax=jax, jnp=jnp, bs=j_bs, deformable=j_def, dist=j_dist, halo=j_halo)


@functools.lru_cache(maxsize=None)
def _jax_pair(n):
    from test_parallel import _random_pair

    data, state, hyper, _ = _random_pair(n)
    return data, state, hyper


def _port(data, state, hyper, device="cpu"):
    return (convert.pair_data_from_numpy(data, device), convert.pair_state_from_numpy(state, device),
            convert.hyper_from_numpy(hyper, device))


def _mesh(S):
    J = _jx()
    return J.dist.make_mesh(J.jax.devices()[:S])


# ---------------------------------------------------------------------------
# The host plan: exactly JAX's.
# ---------------------------------------------------------------------------


def _assert_same(t, j, what):
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j), err_msg=what)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [25, 64, 1000])
def test_plan_pad_permute_equal_jax(n, S):
    J = _jx()
    jd, js, jh = _jax_pair(n)
    td, ts, _ = _port(jd, js, jh)
    jd_p, js_p, jn = J.halo.pad_pair(jd, js, S)
    td_p, ts_p, tn = t_halo.pad_pair(td, ts, S)
    assert tn == jn == n
    for name in t_def.PairData._fields:
        _assert_same(getattr(td_p, name), getattr(jd_p, name), f"pad_pair data.{name}")
    for name in t_def.PairState._fields:
        _assert_same(getattr(ts_p, name), getattr(js_p, name), f"pad_pair state.{name}")
    xy = ts_p.p1.numpy()[:, :2]
    np.testing.assert_array_equal(t_halo.morton_perm(xy), J.halo.morton_perm(np.asarray(js_p.p1)[:, :2]))
    jp = J.halo.plan_halo(np.asarray(js_p.p1), np.asarray(jd_p.nbr), np.asarray(jd_p.nbr_mask), S)
    tp = t_halo.plan_halo(ts_p.p1.numpy(), td_p.nbr.numpy(), td_p.nbr_mask.numpy(), S)
    handed = convert.halo_plan_from_numpy(jp)
    for name in t_halo.HaloPlan._fields:
        a, b = getattr(tp, name), getattr(handed, name)
        np.testing.assert_array_equal(a, b, err_msg=f"plan_halo {name}")
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    jperm = J.halo.permute_data(jd_p, jp)
    tperm = t_halo.permute_data(td_p, tp)
    for name in t_def.PairData._fields:
        _assert_same(getattr(tperm, name), getattr(jperm, name), f"permute_data {name}")
    _assert_same(t_halo.permute_state(ts_p, tp).p1, J.halo.permute_state(js_p, jp).p1, "permute_state")
    back = t_halo.unpermute_state(t_halo.permute_state(ts_p, tp), tp)
    assert torch.equal(back.p1, ts_p.p1) and torch.equal(back.p2, ts_p.p2)


def test_assemble_diag_matches_jax_and_dense_diag():
    J = _jx()
    from test_deformable import make_problem

    data, state0, hyper, _ = make_problem(n_side=4)
    jdiag = np.asarray(J.jax.jit(J.deformable.assemble_diag, static_argnums=0)("KB8", data, hyper, state0))
    td, ts, th = _port(data, state0, hyper)
    tdiag = t_def.assemble_diag("KB8", td, th, ts)
    np.testing.assert_allclose(tdiag.numpy(), jdiag, rtol=1e-5)
    H, _ = t_def.build_system("KB8", td, th, ts)
    np.testing.assert_allclose(tdiag.numpy(), torch.diagonal(H).numpy(), rtol=1e-5)
    assert torch.equal(t_dist.hessian_diag("KB8", td, th, ts), tdiag)


# ---------------------------------------------------------------------------
# The sharded solves: one spawn per world size runs every case.
# ---------------------------------------------------------------------------


def _rank_job(p):
    """Every case of one world size, on this rank (run by launch.run_ranks)."""
    torch.set_num_threads(1)
    mesh = t_dist.make_mesh("cpu")
    S = mesh.size
    P = t_dist.POINTS_AXIS
    data, state, hyper = p["pair"]
    spec = t_def.ModelSpec()
    out = {}

    # One damped solve of the fixed system at JAX's first damping.
    d, s, _ = t_halo.pad_pair(data, state, S)
    plan = t_halo.plan_halo(s.p1.numpy(), d.nbr.numpy(), d.nbr_mask.numpy(), S)
    dp, sp = t_dist.shard_pair(mesh, t_halo.permute_data(d, plan), t_halo.permute_state(s, plan))
    shp = t_dist.ShardedPair(mesh, "KB8", dp, hyper, spec)
    sys_, _ = shp.system(sp)
    t_dist.reset_counts()
    x_p, x_g = t_halo.pcg_halo_local(shp, sys_, torch.tensor(p["lam"]), t_halo.place_plan(mesh, plan),
                                     p["cap"], PCG_RTOL)
    counts = dict(t_dist.COUNTS)
    out["pcg"] = dict(x=t_bs._join(t_dist.gather_rows(mesh, P, x_p, "test"), x_g), x_g=x_g, counts=counts,
                      n_boundary=plan.n_boundary)

    for it in p["iters"]:
        t_dist.reset_counts()
        r = t_halo.solve_pair_halo(mesh, "KB8", data, hyper, state, it, cg_iters=CG)
        out[("halo", it)] = dict(cost=float(r.cost), n_accepted=r.n_accepted, p1=r.state.p1,
                                 counts=dict(t_dist.COUNTS))
        if p["baseline"]:
            t_dist.reset_counts()
            sd, ss = t_dist.shard_pair(mesh, data, state)
            r = t_dist.solve_pair_distributed("KB8", sd, hyper, ss, it, cg_iters=CG, mesh=mesh)
            out[("baseline", it)] = dict(cost=float(r.cost), n_accepted=r.n_accepted,
                                         p1=t_dist.gather_state(mesh, r.state).p1, counts=dict(t_dist.COUNTS))
    if p.get("serving") is not None:
        bd, bs, bh = p["serving"]
        smesh = t_dist.make_serving_mesh("cpu")
        for it in p["iters"]:
            r = t_dist.solve_pairs_sharded(smesh, "KB8", bd, bh, bs, it)
            out[("serving", it)] = dict(cost=r.cost, p1=r.state.p1, n_accepted=r.n_accepted)
    if p.get("block_budget") is not None:
        # Last, since it patches the package: a dense budget that the whole
        # batch exceeds and one rank's slice alone would not.
        from triangulation_in_deformable_scenes_torch.ops import block_pcg

        t_def.DENSE_J_BUDGET_BYTES = p["block_budget"]
        pcg, calls = block_pcg.pcg_block_system, []
        block_pcg.pcg_block_system = lambda *a: (calls.append(1), pcg(*a))[1]
        r = t_dist.solve_pairs_sharded(smesh, "KB8", bd, bh, bs, ITERS[-1])
        out["serving_block"] = dict(cost=r.cost, p1=r.state.p1, n_accepted=r.n_accepted, pcg_calls=len(calls))
    return out


@functools.lru_cache(maxsize=None)
def _serving_problem():
    J = _jx()
    from test_deformable import make_problem

    problems = [make_problem(n_side=4, seed=s) for s in range(SERVING_PAIRS)]
    bd = J.jax.tree_util.tree_map(lambda *xs: J.jnp.stack(xs), *[p[0] for p in problems])
    bs = J.jax.tree_util.tree_map(lambda *xs: J.jnp.stack(xs), *[p[1] for p in problems])
    return bd, bs, problems[0][2]


@functools.lru_cache(maxsize=None)
def _jax_lam():
    """The LM loop's first damping on the unsharded pair's block system."""
    J = _jx()
    jd, js, jh = _jax_pair(N_SOLVE)
    sys_ = J.bs.build_block_system("KB8", jd, jh, js, J.deformable.ModelSpec())
    return float(1e-5 * J.jnp.max(J.bs.diag_of(sys_)))


def _serving_block_budget():
    """A dense budget of exactly half the serving batch's Jacobian: the
    whole batch takes the block backend, one of two ranks' halves the dense."""
    td, ts, _ = _port(*_serving_problem())
    n, K = ts.p1.shape[1], td.nbr.shape[-1]
    return (SERVING_PAIRS // 2) * (n * (6 + K) + 2) * t_def._tangent_dim(n) * 4


@functools.lru_cache(maxsize=None)
def _port_runs(world):
    payload = dict(pair=_port(*_jax_pair(N_SOLVE)), lam=_jax_lam(), cap=t_def.CG_ITERS, iters=ITERS,
                   baseline=world == 2, serving=_port(*_serving_problem()) if world == 2 else None,
                   block_budget=_serving_block_budget() if world == 2 else None)
    return launch.run_ranks(world, "tests.test_torch_parallel:_rank_job", payload, device="cpu",
                            timeout=RANK_TIMEOUT_S, cwd=REPO)


def _jax_halo_x(S, cap):
    """x of one halo damped solve at ``cap`` iterations (permuted layout)."""
    J = _jx()
    jd, js, jh = _jax_pair(N_SOLVE)
    mesh = _mesh(S)
    d, s, _ = J.halo.pad_pair(jd, js, S)
    plan = J.halo.plan_halo(np.asarray(s.p1), np.asarray(d.nbr), np.asarray(d.nbr_mask), S)
    dp, sp = J.dist.shard_pair(mesh, J.halo.permute_data(d, plan), J.halo.permute_state(s, plan))

    @J.jax.jit
    def solve(dp, sp, plan_arrays, lam):
        step = J.halo.make_halo_step(mesh, "KB8", dp, jh, J.deformable.ModelSpec(), plan_arrays, cap, PCG_RTOL)
        return step(sp)[0](lam)

    return np.asarray(solve(dp, sp, J.halo.place_plan(mesh, plan), J.jnp.asarray(_jax_lam(), J.jnp.float32)))


@pytest.mark.parametrize("S", [2, 4])
def test_halo_damped_solve_matches_jax(S):
    ranks = _port_runs(S)
    got = ranks[0]["pcg"]
    k = got["counts"]["cg_iterations"]
    x_jax = _jax_halo_x(S, t_def.CG_ITERS)
    # JAX's loop returns x only: it took k iterations iff capping it at k
    # changes nothing and capping it at k - 1 does.
    assert 0 < k < t_def.CG_ITERS
    assert np.array_equal(_jax_halo_x(S, k), x_jax), f"JAX's PCG took more than the port's {k} iterations"
    assert not np.array_equal(_jax_halo_x(S, k - 1), x_jax), f"JAX's PCG took fewer than the port's {k} iterations"
    x = got["x"].numpy()
    assert np.abs(x - x_jax).max() <= 1e-4 * np.abs(x_jax).max()
    for r in ranks[1:]:
        assert torch.equal(r["pcg"]["x_g"], got["x_g"]) and torch.equal(r["pcg"]["x"], got["x"])
        assert r["pcg"]["counts"]["cg_iterations"] == k


@pytest.mark.parametrize("S", [2, 4])
def test_halo_pcg_three_all_reduces_per_iteration(S):
    for r in _port_runs(S):
        for c, nb in [(r["pcg"]["counts"], r["pcg"]["n_boundary"])] + [
                (r[("halo", it)]["counts"], None) for it in ITERS]:
            k, solves = c["cg_iterations"], c["pcg_solves"]
            assert k > 0 and c["pcg_matvec"] == k and c["pcg_dot"] == k and c["pcg_rz_rr"] == k + solves
            if nb is not None:
                assert c["pcg_matvec_floats"] == k * (6 * nb + 8) and c["pcg_dot_floats"] == k
                assert c["pcg_rz_rr_floats"] == 2 * (k + solves)


@functools.lru_cache(maxsize=None)
def _jax_solve(kind, S, it):
    J = _jx()
    jd, js, jh = _jax_pair(N_SOLVE)
    if kind == "halo":
        r = J.halo.solve_pair_halo(_mesh(S), "KB8", jd, jh, js, n_iterations=it, cg_iters=CG)
    else:
        r = J.dist.solve_pair_distributed("KB8", jd, jh, js, n_iterations=it, cg_iters=CG)
    return float(r.cost), int(r.n_accepted), np.asarray(r.state.p1)


def _hold(got, kind, S, it):
    cost, n_acc, p1 = _jax_solve(kind, S, it)
    if it == 1:
        np.testing.assert_allclose(got["p1"].numpy(), p1, rtol=5e-3, atol=1e-4)
        assert abs(got["cost"] - cost) <= 1e-3 * cost
    else:
        assert abs(got["cost"] - cost) <= 2e-2 * cost
    assert got["n_accepted"] == n_acc


@pytest.mark.parametrize("it", ITERS)
@pytest.mark.parametrize("S", [2, 4])
def test_solve_pair_halo_matches_jax(S, it):
    ranks = _port_runs(S)
    _hold(ranks[0][("halo", it)], "halo", S, it)
    for r in ranks[1:]:
        assert r[("halo", it)]["cost"] == ranks[0][("halo", it)]["cost"]
        assert torch.equal(r[("halo", it)]["p1"], ranks[0][("halo", it)]["p1"])


@pytest.mark.parametrize("it", ITERS)
@pytest.mark.parametrize("world", [1, 2])
def test_solve_pair_distributed_matches_jax(world, it):
    if world == 1:
        td, ts, th = _port(*_jax_pair(N_SOLVE))
        r = t_dist.solve_pair_distributed("KB8", td, th, ts, it, cg_iters=CG, mesh=t_dist.make_mesh("cpu"))
        got = dict(cost=float(r.cost), n_accepted=r.n_accepted, p1=r.state.p1)
        ranks = [dict(cost=got["cost"])]
    else:
        ranks = [r[("baseline", it)] for r in _port_runs(world)]
        got = ranks[0]
        nb = N_SOLVE
        c = got["counts"]
        assert c["pcg_matvec_floats"] == c["pcg_matvec"] * (6 * nb + 8)
    _hold(got, "baseline", 1, it)
    assert all(r["cost"] == ranks[0]["cost"] for r in ranks)


@pytest.mark.parametrize("it,rtol", [(1, 1e-5), (5, 1e-4)])
def test_halo_one_shard_is_the_block_step(it, rtol):
    """At one rank the halo solve is make_block_step on the Morton-permuted
    pair: the baseline's cost up to the summation order (4.8e-7 after one
    iteration, 2.0e-5 after five on this pair: each PCG stops at rtol 1e-2,
    and what it leaves out follows the order)."""
    td, ts, th = _port(*_jax_pair(N_SOLVE))
    mesh = t_dist.make_mesh("cpu")
    t_dist.reset_counts()
    rh = t_halo.solve_pair_halo(mesh, "KB8", td, th, ts, it, cg_iters=CG)
    rb = t_dist.solve_pair_distributed("KB8", td, th, ts, it, cg_iters=CG)
    assert rh.n_accepted == rb.n_accepted and rh.n_solves == rb.n_solves
    assert abs(float(rh.cost) - float(rb.cost)) <= rtol * float(rb.cost)
    assert rh.state.p1.shape == ts.p1.shape
    assert not t_dist.COUNTS


@pytest.mark.parametrize("case", ["indivisible", "no-pair-axis"])
def test_shard_pairs_rejects_as_jax(case):
    J = _jx()
    bd, bs, hyper = _serving_problem()
    if case == "indivisible":
        bd = J.jax.tree_util.tree_map(lambda x: x[:3], bd)
        bs = J.jax.tree_util.tree_map(lambda x: x[:3], bs)
    else:
        bd = bd._replace(area=bd.area[0])
    with pytest.raises(ValueError) as jerr:
        J.dist.shard_pairs(J.dist.make_serving_mesh(J.jax.devices()[:2]), bd, bs)
    # A 2-rank layout needs no process group to slice (no collective).
    mesh = t_dist.Mesh((t_dist.PAIRS_AXIS,), np.arange(2), [None], torch.device("cpu"))
    td = convert.pair_data_from_numpy(bd, "cpu")
    ts = convert.pair_state_from_numpy(bs, "cpu")
    with pytest.raises(ValueError) as terr:
        t_dist.shard_pairs(mesh, td, ts)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("it", ITERS)
def test_pair_sharded_serving_matches(it):
    J = _jx()
    bd, bs, hyper = _serving_problem()
    ranks = [r[("serving", it)] for r in _port_runs(2)]
    got = ranks[0]
    for r in ranks[1:]:
        assert torch.equal(r["cost"], got["cost"]) and torch.equal(r["p1"], got["p1"])
    td, ts, th = _port(bd, bs, hyper)
    alone = t_def.solve_pairs("KB8", td, th, ts, it)
    np.testing.assert_allclose(got["p1"].numpy(), alone.state.p1.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["cost"].numpy(), alone.cost.numpy(), rtol=1e-6)
    assert torch.equal(got["n_accepted"], alone.n_accepted)
    mesh = J.dist.make_serving_mesh(J.jax.devices()[:2])
    sd, ss = J.dist.shard_pairs(mesh, bd, bs)
    jr = J.deformable.solve_pairs("KB8", sd, hyper, ss, n_iterations=it)
    if it == 1:
        np.testing.assert_allclose(got["p1"].numpy(), np.asarray(jr.state.p1), rtol=1e-3, atol=1e-6)
    else:
        np.testing.assert_allclose(got["p1"].numpy(), np.asarray(jr.state.p1), rtol=5e-2, atol=1e-5)
        np.testing.assert_allclose(got["cost"].numpy(), np.asarray(jr.cost), rtol=0.2)


def test_pair_sharded_serving_keeps_the_whole_batch_backend(monkeypatch):
    """With the dense budget between one rank's half of the batch and the
    whole batch, each rank's slice runs the whole batch's block backend (as
    JAX dispatches on the global shape) and matches the unsharded batch."""
    td, ts, th = _port(*_serving_problem())
    n, K = ts.p1.shape[1], td.nbr.shape[-1]
    monkeypatch.setattr(t_def, "DENSE_J_BUDGET_BYTES", _serving_block_budget())
    assert not t_def.use_dense_backend(n, K, SERVING_PAIRS) and t_def.use_dense_backend(n, K, SERVING_PAIRS // 2)
    alone = t_def.solve_pairs("KB8", td, th, ts, ITERS[-1])
    for r in _port_runs(2):
        got = r["serving_block"]
        assert got["pcg_calls"] > 0
        np.testing.assert_allclose(got["p1"].numpy(), alone.state.p1.numpy(), rtol=1e-6, atol=0)
        np.testing.assert_allclose(got["cost"].numpy(), alone.cost.numpy(), rtol=1e-6)
        assert torch.equal(got["n_accepted"], alone.n_accepted)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_world1_distributed_solve_runs_kernel2():
    """At one rank solve_pair_distributed is make_block_step: one kernel-2
    launch a damped solve, the cost within 2e-2 of the CPU's."""
    _cuda()
    from triangulation_in_deformable_scenes_torch.ops import block_pcg

    td, ts, th = _port(*_jax_pair(N_SOLVE), device="cuda")
    before = block_pcg.LAUNCHES
    r = t_dist.solve_pair_distributed("KB8", td, th, ts, 5, cg_iters=CG, mesh=t_dist.make_mesh("cuda"))
    assert block_pcg.LAUNCHES - before == r.n_solves
    cd, cs, ch = _port(*_jax_pair(N_SOLVE))
    cpu = t_dist.solve_pair_distributed("KB8", cd, ch, cs, 5, cg_iters=CG)
    assert abs(float(r.cost) - float(cpu.cost)) <= 2e-2 * float(cpu.cost)


@pytest.mark.cuda
def test_cuda_pair_sharded_batch_is_bit_identical():
    """Each pair of the sharded batch (one rank) is the unsharded
    solve_pairs' bit for bit on the card (kernel 1's batched entry)."""
    _cuda()
    td, ts, th = _port(*_serving_problem(), device="cuda")
    sharded = t_dist.solve_pairs_sharded(t_dist.make_serving_mesh("cuda"), "KB8", td, th, ts, 5)
    alone = t_def.solve_pairs("KB8", td, th, ts, 5)
    assert torch.equal(sharded.cost, alone.cost) and torch.equal(sharded.state.p1, alone.state.p1)


# ---------------------------------------------------------------------------
# Script mode: the JAX values of chip_smoke.py phase 20.
# ---------------------------------------------------------------------------


def _constants():
    from triangulation_in_deformable_scenes_torch.harness import scaling, serving
    from triangulation_in_deformable_scenes_torch.parallel import multihost_worker as t_worker
    from triangulation_in_deformable_scenes_tpu.parallel import multihost_worker as j_worker

    J = _jx()
    n = scaling.POINTS
    jd, js, jh = _jax_pair(n)
    p1, p2, _ = serving.draw_pairs(n, 1, 0)[0]
    fv = serving.free_vertices(p1, p2, np.asarray(jd.nbr), np.asarray(jd.wcot))
    Ri = np.asarray(jd.Ri)
    print(f"JAX_SCALING_FREE_RI = {{{', '.join(f'{v}: {Ri[v].ravel().tolist()}' for v in fv)}}}")
    for S in (2, 4):
        d, s, _ = J.halo.pad_pair(jd, js, S)
        plan = J.halo.plan_halo(np.asarray(s.p1), np.asarray(d.nbr), np.asarray(d.nbr_mask), S)
        print(f"JAX_SCALING_N_BOUNDARY_{S} = {plan.n_boundary}")
    for it in (1, scaling.ITERATIONS):
        r = J.dist.solve_pair_distributed("KB8", jd, jh, js, n_iterations=it, cg_iters=scaling.CG_ITERS)
        print(f"JAX_SCALING_COST_{it} = {float(r.cost)!r}  # n_accepted {int(r.n_accepted)}", flush=True)
        for S in (2, 4):
            r = J.halo.solve_pair_halo(_mesh(S), "KB8", jd, jh, js, n_iterations=it, cg_iters=scaling.CG_ITERS)
            print(f"JAX_SCALING_HALO{S}_COST_{it} = {float(r.cost)!r}  # n_accepted {int(r.n_accepted)}",
                  flush=True)
    # The multihost worker's 5 x 5 problem, padded to 26 for two ranks.
    td, th, ts = t_worker._tiny_problem(5, "cpu")
    data, hyper, state = j_worker._tiny_problem(5)
    print(f"TINY_PORT_CPU_RI_MAX_DIFF = {float(np.abs(td.Ri.numpy() - np.asarray(data.Ri)).max())!r}")
    d, s, _ = J.halo.pad_pair(data, state, 2)
    for it in (1, scaling.ITERATIONS):
        r = J.dist.solve_pair_distributed("KB8", d, hyper, s, n_iterations=it, cg_iters=scaling.CG_ITERS)
        print(f"JAX_TINY_COST_{it} = {float(r.cost)!r}  # n_accepted {int(r.n_accepted)}", flush=True)


if __name__ == "__main__":
    _constants()
