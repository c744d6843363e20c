"""Multi-rank dry runs, the counterpart of ``__graft_entry__.dryrun_multichip``
(``:91-149``) and ``dryrun_multiprocess`` (``:152-208``) of the JAX package's
root.

``dryrun_multichip(n)`` starts n ranks (subprocesses joined by
``torch.distributed``) and runs on them, with JAX's asserts (finite cost,
descended, and here also the same cost on every rank): the landmark-sharded
baseline solve, the halo solve and one pair-sharded serving step.
``dryrun_multiprocess(n)`` starts n copies of
``parallel/multihost_worker`` in both modes and asserts that every rank
descended to the same cost.

Both run on the card unless ``device="cpu"``. NCCL takes one rank a card,
so n ranks on CUDA need n cards, or ``backend="gloo"`` asked for by name
(the ranks then share the card).

    python -m triangulation_in_deformable_scenes_torch.graft_entry [n] [--device cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def _check_layout(n: int, device, backend):
    import torch

    if torch.device(device).type == "cuda" and backend is None:
        from .device import resolve_device

        resolve_device(device)
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} NCCL ranks need {n} cards ({torch.cuda.device_count()} visible); "
                             f"pass backend='gloo' to share one")


def _multichip_rank(payload) -> dict:
    """One rank of ``dryrun_multichip``."""
    import numpy as np

    from .models import deformable
    from .ops import lm as lm_ops
    from .parallel import dist, halo
    from .parallel.multihost_worker import _tiny_problem

    mesh = dist.make_mesh(payload["device"])
    n_dev = mesh.size
    n_side = max(4, int(np.ceil(np.sqrt(2 * n_dev))))
    while (n_side * n_side) % n_dev:
        n_side += 1
    data, hyper, state0 = _tiny_problem(n_side, mesh.device)
    sdata, sstate = dist.shard_pair(mesh, data, state0)
    res = dist.solve_pair_distributed("KB8", sdata, hyper, sstate, n_iterations=1, cg_iters=25, mesh=mesh)
    cost = float(res.cost)
    assert np.isfinite(cost), "distributed step produced non-finite cost"
    assert cost <= float(res.initial_cost) * 1.01, "distributed step did not descend"

    hres = halo.solve_pair_halo(mesh, "KB8", data, hyper, state0, n_iterations=1, cg_iters=25)
    hcost = float(hres.cost)
    assert np.isfinite(hcost), "halo-sharded step produced non-finite cost"
    assert hcost <= float(hres.initial_cost) * 1.01, "halo-sharded step did not descend"

    bdata, bhyper, bstate = _tiny_problem(4, mesh.device)
    bd, bs = lm_ops.stack([bdata] * n_dev), lm_ops.stack([bstate] * n_dev)
    smesh = dist.make_serving_mesh(payload["device"])
    bres = dist.solve_pairs_sharded(smesh, "KB8", bd, bhyper, bs, n_iterations=1)
    bcosts = bres.cost.cpu().numpy()
    assert np.all(np.isfinite(bcosts)), "pair-sharded serving step produced non-finite cost"
    assert np.all(bcosts <= bres.initial_cost.cpu().numpy() * 1.01), "serving step did not descend"
    return {"n": int(data.kp1.shape[0]), "initial_cost": float(res.initial_cost), "cost": cost,
            "halo_cost": hcost, "serving_costs": bcosts.tolist()}


def dryrun_multichip(n_ranks: int, device="cuda", backend: str | None = None) -> None:
    """ONE landmark-sharded LM step (baseline and halo) and one pair-sharded
    serving step over ``n_ranks`` ranks."""
    from .parallel import launch

    _check_layout(n_ranks, device, backend)
    outs = launch.run_ranks(n_ranks, f"{__package__}.graft_entry:_multichip_rank", {"device": str(device)},
                            device=device, backend=backend, timeout=TIMEOUT_S, cwd=REPO)
    assert all(o == outs[0] for o in outs), f"ranks disagree: {outs}"
    r = outs[0]
    print(f"dryrun_multichip: {n_ranks} ranks, N={r['n']} landmarks, cost {r['initial_cost']:.4e} -> "
          f"{r['cost']:.4e} (halo {r['halo_cost']:.4e}); pair-sharded serving batch={n_ranks} OK")


def dryrun_multiprocess(n_processes: int = 2, device="cuda", backend: str | None = None) -> None:
    """``n_processes`` ranks of ``parallel/multihost_worker`` in both modes:
    every rank descended, to the same cost."""
    from .parallel import launch

    _check_layout(n_processes, device, backend)
    argv = ["-m", f"{__package__}.parallel.multihost_worker", "--device", str(device)]
    if backend:
        argv += ["--backend", backend]
    for mode in ("baseline", "halo"):
        outs = launch.spawn(n_processes, argv + [mode], timeout=TIMEOUT_S, cwd=REPO)
        results = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        assert all(r["descended"] for r in results)
        assert len({r["final_cost"] for r in results}) == 1, f"ranks disagree: {results}"
        print(f"dryrun_multiprocess[{mode}]: {n_processes} processes, cost {results[0]['initial_cost']:.4e} -> "
              f"{results[0]['final_cost']:.4e} (identical on all processes) OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-rank dry runs of the port")
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)
    dryrun_multiprocess(args.n, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
