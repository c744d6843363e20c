"""One rank of a multi-process smoke run (see ``parallel/multihost.py``);
counterpart of ``triangulation_in_deformable_scenes_tpu/parallel/multihost_worker.py``.

Launch one copy per rank::

    TIDS_COORDINATOR=host0:8476 TIDS_NUM_PROCESSES=P TIDS_PROCESS_ID=$RANK \\
        python -m triangulation_in_deformable_scenes_torch.parallel.multihost_worker [baseline|halo]

Each rank starts the process group, lays every rank of every host on the
points axis, landmark-shards one synthetic deformable pair across it, runs
the distributed LM solve (2 iterations, ``cg_iters`` 25) and prints one
JSON line with its view of the costs. All ranks must print identical
costs. ``baseline`` is ``dist.solve_pair_distributed`` (the whole packed
tangent exchanged per matvec), ``halo`` is ``halo.solve_pair_halo_global``
(the boundary rows; a 5 x 5 grid, so the padding to the rank count runs).

``--device cpu`` runs it on the CPU over gloo; on the card it uses NCCL,
or gloo where ``--backend gloo`` asks for it (several ranks on one card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _tiny_problem(n_side: int, device="cuda"):
    """The JAX worker's synthetic pair (``multihost_worker.py:29-67`` there)."""
    import numpy as np
    import torch

    from ..models import deformable
    from ..ops import camera, lie
    from ..precision import FP

    dev = torch.device(device)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=FP, device=dev)
    cam = np.array([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0], dtype=np.float64)
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.linspace(-0.05, 0.05, n_side), np.linspace(-0.04, 0.04, n_side))
    p1 = np.stack([xs.ravel(), ys.ravel(), 0.2 + 0.004 * np.sin(xs.ravel() * 50)], axis=-1)
    p2 = p1 + 0.003 * np.stack(
        [np.sin(p1[:, 1] * 30), np.cos(p1[:, 0] * 25), np.sin(p1[:, 0] * 40)], axis=-1
    )
    c1 = np.array([-0.10, 0.02, 0.0])
    c2 = np.array([0.12, 0.01, 0.0])
    T1w = (lie.look_at(t(c1), t(p1.mean(0))), t(c1))
    T2w = (lie.look_at(t(c2), t(p2.mean(0))), t(c2))
    pc1 = lie.apply(*T1w, t(p1))
    pc2 = lie.apply(*T2w, t(p2))
    kp1 = camera.kb8_project(t(cam), pc1).cpu().numpy()
    kp2 = camera.kb8_project(t(cam), pc2).cpu().numpy()
    d1 = pc1[:, 2].cpu().numpy() * 0.4
    d2 = pc2[:, 2].cpu().numpy() * 1.7
    n = len(p1)
    p1_0 = p1 + rng.normal(scale=1e-3, size=p1.shape)
    p2_0 = p2 + rng.normal(scale=1e-3, size=p2.shape)
    data = deformable.make_pair_data(
        kp1=kp1, kp2=kp2, depth1=d1, depth2=d2, valid=np.ones(n, dtype=bool),
        cam_params=cam, T1w=T1w, T2w=T2w, p1=p1_0, p2=p2_0, device=dev,
    )
    state0 = deformable.PairState(p1=t(p1_0), p2=t(p2_0), s1=t(0.42), s2=t(1.6), Rg=t(np.eye(3)), tg=t(np.zeros(3)))
    hyper = deformable.Hyper(rep_w=t(1.0), arap_w=t(1e-3), depth_sigma=t(0.003), global_w=t(50.0))
    return data, hyper, state0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="baseline", choices=("baseline", "halo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="gloo on CUDA tensors only when named (ranks sharing a card)")
    args = ap.parse_args(argv)
    mode = os.environ.get("TIDS_WORKER_MODE") or args.mode

    import numpy as np
    import torch.distributed as tdist

    from . import dist, halo, multihost

    multihost.initialize(device=args.device, backend=args.backend)
    mesh = multihost.points_submesh(args.device)
    n_dev = mesh.size
    # Halo mode: 5 x 5 = 25 landmarks, not divisible by most rank counts,
    # so pad_pair's padding runs on the global layout.
    if mode == "halo":
        n_side = 5
    else:
        n_side = 4
        while (n_side * n_side) % n_dev:
            n_side += 1
    data, hyper, state0 = _tiny_problem(n_side, mesh.device)
    if mode == "halo":
        res, _plan, _n = halo.solve_pair_halo_global(mesh, "KB8", data, hyper, state0, n_iterations=2, cg_iters=25)
    else:
        sdata, sstate = multihost.shard_pair_global(mesh, data, state0)
        res = dist.solve_pair_distributed("KB8", sdata, hyper, sstate, n_iterations=2, cg_iters=25, mesh=mesh)

    # Costs are reduced over every rank: each holds the whole pair's.
    cost = float(res.cost)
    cost0 = float(res.initial_cost)
    ok = bool(np.isfinite(cost)) and cost <= cost0 * 1.01
    print(json.dumps({
        "mode": mode,
        "process_id": mesh.rank,
        "num_processes": dist.world()[0],
        "global_devices": n_dev,
        "local_devices": 1,
        "initial_cost": cost0,
        "final_cost": cost,
        "descended": ok,
    }), flush=True)
    if tdist.is_initialized():
        tdist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
