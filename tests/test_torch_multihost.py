"""The port's multi-process start-up (``parallel/multihost.py``,
``parallel/multihost_worker.py``) on the CPU, against the JAX package's
worker.

Two worker processes joined over gloo (``--device cpu``; a ``file://``
init method, so no TCP port is picked) run both modes on the JAX worker's
problem: both descend and print the same cost, within 1e-3 of JAX's worker
(its 2 processes x 4 virtual devices make one 8-device mesh, so the JAX
value is the 8-device solve, computed here in-process on the conftest's 8
virtual devices). Each rank has a wall-clock limit, so a hang fails.
"""

import json
import os

import numpy as np
import pytest
import torch

from triangulation_in_deformable_scenes_torch.parallel import dist, launch, multihost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "triangulation_in_deformable_scenes_torch.parallel.multihost_worker"


def test_initialize_noop_without_config(monkeypatch):
    for name in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES, multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize(device="cpu")  # must not raise or start a process group
    assert not torch.distributed.is_initialized()
    assert dist.world() == (1, 0)


def test_initialize_needs_all_three_variables(monkeypatch):
    monkeypatch.setenv(multihost.ENV_COORDINATOR, "localhost:1")
    monkeypatch.delenv(multihost.ENV_NUM_PROCESSES, raising=False)
    monkeypatch.delenv(multihost.ENV_PROCESS_ID, raising=False)
    with pytest.raises(ValueError):
        multihost.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world,local,shape", [(8, "4", (2, 4)), (8, None, (1, 8)), (6, "2", (3, 2)),
                                               (1, None, (1, 1))])
def test_multihost_layout(monkeypatch, world, local, shape):
    """Pairs across hosts (rows), points across a host's ranks (columns),
    grouped by LOCAL_WORLD_SIZE; one host without it."""
    grid = multihost.host_grid(world, None if local is None else int(local))
    assert grid.shape == shape
    np.testing.assert_array_equal(grid.ravel(), np.arange(world))
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    if world == 1:
        mesh = multihost.multihost_mesh("cpu")
        assert mesh.axis_names == (dist.PAIRS_AXIS, dist.POINTS_AXIS) and mesh.ranks.shape == (1, 1)
        assert multihost.points_submesh("cpu").size == 1
    with pytest.raises(ValueError):
        multihost.host_grid(world + 1, 4 if local is None else int(local) * 2)


def test_local_rank(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert multihost.local_rank(6) == 2
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.local_rank(6) == 1


def test_make_global_array_keeps_own_rows():
    mesh = dist.Mesh((dist.POINTS_AXIS,), np.arange(1), [None], torch.device("cpu"))
    x = np.arange(12.0).reshape(6, 2)
    assert torch.equal(multihost.make_global_array(x, mesh, dist.POINTS_AXIS), torch.as_tensor(x))
    assert torch.equal(multihost.make_global_array(x, mesh), torch.as_tensor(x))


def _jax_worker_cost(mode):
    import jax

    from triangulation_in_deformable_scenes_tpu.parallel import dist as j_dist
    from triangulation_in_deformable_scenes_tpu.parallel import halo as j_halo
    from triangulation_in_deformable_scenes_tpu.parallel.multihost_worker import _tiny_problem

    mesh = j_dist.make_mesh(jax.devices()[:8])
    if mode == "halo":
        data, hyper, state0 = _tiny_problem(5)
        res = j_halo.solve_pair_halo(mesh, "KB8", data, hyper, state0, n_iterations=2, cg_iters=25)
    else:
        data, hyper, state0 = _tiny_problem(4)
        sdata, sstate = j_dist.shard_pair(mesh, data, state0)
        res = j_dist.solve_pair_distributed("KB8", sdata, hyper, sstate, n_iterations=2, cg_iters=25)
    return float(res.initial_cost), float(res.cost)


@pytest.mark.parametrize("mode", ["baseline", "halo"])
def test_two_process_worker(mode):
    outs = launch.spawn(2, ["-m", WORKER, mode, "--device", "cpu"], timeout=120, cwd=REPO)
    results = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    by_rank = {r["process_id"]: r for r in results}
    assert set(by_rank) == {0, 1}
    for r in results:
        assert r["mode"] == mode and r["num_processes"] == 2 and r["global_devices"] == 2
        assert r["local_devices"] == 1 and r["descended"]
    assert by_rank[0]["final_cost"] == by_rank[1]["final_cost"]
    assert by_rank[0]["initial_cost"] == by_rank[1]["initial_cost"]
    j0, j1 = _jax_worker_cost(mode)
    assert abs(by_rank[0]["initial_cost"] - j0) <= 1e-3 * j0
    assert abs(by_rank[0]["final_cost"] - j1) <= 1e-3 * j1


def _mesh_job(_payload):
    """One rank of test_multihost_mesh_groups: its place in the 2-D layout
    and the sums of the ranks along each axis."""
    torch.set_num_threads(1)
    mesh = multihost.multihost_mesh("cpu")
    sums = {axis: float(mesh.all_reduce(torch.tensor([float(mesh.rank)]), axis, "test")[0])
            for axis in (dist.PAIRS_AXIS, dist.POINTS_AXIS)}
    return dict(rank=mesh.rank, coords=mesh.coords, shape=mesh.ranks.shape, sums=sums)


def test_multihost_mesh_groups(monkeypatch):
    """4 ranks as 2 hosts of 2 (LOCAL_WORLD_SIZE=2): the points axis sums
    within a host, the pairs axis across hosts."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    outs = launch.run_ranks(4, "tests.test_torch_multihost:_mesh_job", None, device="cpu", timeout=120, cwd=REPO)
    for r, o in enumerate(outs):
        host, local = divmod(r, 2)
        assert o["rank"] == r and o["coords"] == (host, local) and o["shape"] == (2, 2)
        assert o["sums"][dist.POINTS_AXIS] == 2 * host + (2 * host + 1)
        assert o["sums"][dist.PAIRS_AXIS] == local + (2 + local)
