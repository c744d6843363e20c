"""Multi-process start-up and the (pairs, points) layout across hosts.

Counterpart of ``triangulation_in_deformable_scenes_tpu/parallel/multihost.py``.
There ``jax.distributed`` joins processes into one global device mesh;
here every rank is one process with one device, joined by
``torch.distributed.init_process_group``.

Topology: independent pairs go ACROSS hosts (no traffic between them in
the solve), the landmark axis stays WITHIN a host, where the per-matvec
exchange runs. ``multihost_mesh`` builds that layout, grouping the ranks
by host with torchrun's ``LOCAL_WORLD_SIZE`` (one host without it).

Launch (one command per rank)::

    TIDS_COORDINATOR=host0:8476 TIDS_NUM_PROCESSES=4 TIDS_PROCESS_ID=$RANK \\
        python your_driver.py

with ``initialize()`` called before any other collective. The backend
follows the device: NCCL for CUDA, gloo for the CPU; gloo on CUDA tensors
only when the caller names it (several ranks sharing one card, which NCCL
refuses). Every process group gets a ``timeout``, so that a rank left
waiting in a collective fails instead of hanging.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

from ..device import resolve_device
from . import dist

ENV_COORDINATOR = "TIDS_COORDINATOR"
ENV_NUM_PROCESSES = "TIDS_NUM_PROCESSES"
ENV_PROCESS_ID = "TIDS_PROCESS_ID"

# How long a rank waits in a collective before it fails.
TIMEOUT = datetime.timedelta(seconds=120)


def local_rank(process_id: int) -> int:
    """The rank's index on its host: torchrun's ``LOCAL_RANK``, else from
    ``LOCAL_WORLD_SIZE``, else the rank itself (one host)."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return process_id % int(os.environ["LOCAL_WORLD_SIZE"])
    return process_id


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device="cuda",
               backend: str | None = None) -> None:
    """Start the process group; must run before any collective.

    Arguments fall back to ``TIDS_COORDINATOR`` (``host:port``, or a full
    ``tcp://`` / ``file://`` init method) / ``TIDS_NUM_PROCESSES`` /
    ``TIDS_PROCESS_ID``. With none of them set it does nothing (a single
    process needs no group). On CUDA the rank's device is its local rank
    modulo the visible cards.
    """
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator is None and num_processes is None:
        return  # single-process run; nothing to coordinate
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(f"{ENV_COORDINATOR}, {ENV_NUM_PROCESSES} and {ENV_PROCESS_ID} are needed together")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank(process_id) % torch.cuda.device_count())
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    tdist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id,
                             timeout=TIMEOUT)


def host_grid(n_world: int, local_world: int | None) -> np.ndarray:
    """Ranks as [hosts, ranks a host]; one host when ``local_world`` is None."""
    per = n_world if local_world is None else local_world
    if per <= 0 or n_world % per:
        raise ValueError(f"uneven layout: {n_world} ranks over hosts of {per}")
    return np.arange(n_world).reshape(n_world // per, per)


def multihost_mesh(device="cuda") -> dist.Mesh:
    """2-D ("pairs", "points") layout: pairs across hosts, points across the
    ranks of a host (grouped by ``LOCAL_WORLD_SIZE``; one host without it)."""
    n_world, _ = dist.world()
    lws = os.environ.get("LOCAL_WORLD_SIZE")
    grid = host_grid(n_world, int(lws) if lws else None)
    return dist.Mesh((dist.PAIRS_AXIS, dist.POINTS_AXIS), grid, dist.axis_groups(grid), dist.rank_device(device))


def points_submesh(device="cuda") -> dist.Mesh:
    """1-D points layout over every rank of every host (landmark sharding
    that spans hosts; for a pair too large for one host)."""
    return dist.make_mesh(device)


def make_global_array(x, mesh: dist.Mesh, axis=None) -> torch.Tensor:
    """This rank's part of a value every rank holds alike: its rows along
    ``axis`` (the leading dim), or the whole value when ``axis`` is None,
    on the rank's device."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(mesh.device)
    return x if axis is None else dist.rows_of(mesh, axis, x)


def shard_pair_global(mesh: dist.Mesh, data, state):
    """Landmark-shard one pair's (data, state) over a points axis that spans
    processes: each rank keeps its rows (``dist.shard_pair``)."""
    return dist.shard_pair(mesh, data, state)
