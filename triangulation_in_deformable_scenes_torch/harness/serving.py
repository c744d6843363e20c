"""The serving fixture: a batch of independent keyframe pairs to refine.

The JAX package's serving benchmark (``bench.py:676-744``) draws its pairs
from ``np.random.default_rng(seed)``, one after another: n points
``p1 ~ N(0, 0.05^2) + [0, 0, 0.2]`` m, ``p2 = p1 + N(0, 0.005^2)``, pixels
``kp ~ U(100, 600)`` (the same in both frames), identity poses, EuRoC's
KB8 intrinsics, depth-scale priors (1, 1e6, 1, 1e6) and mesh degrees
bucketed to 32; a draw whose K is not 32 is dropped, so that the batch
shares its shapes. Every pair shares one ``Hyper`` (``bench.py:710-713``).

The meshes are built with the scipy backend, as the sweep's fixtures are
(``sweep_config.MESH_BACKEND``): for points in general position the
Delaunay triangulation is unique, so the mesh is the one ``bench.py``
builds (``tests/test_torch_serving.py`` holds the draws to it).

``serving_batch(n_points)`` returns the per-pair lists (what
``solve_pairs_pipelined`` takes) and the stacked batch (what
``solve_pairs`` takes), on ``device``: cuda unless the caller asks for the
CPU (``device.resolve_device``), and per pair the vertices whose frozen
rotation the draw leaves free (``free_vertices``: the pixels are drawn
apart from the points, and some boundary vertices keep a single weighted
edge). ``rotations`` pins those: given another package's frozen rotations
at the free vertices, every pair is that package's problem.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import deformable
from ..ops import lm as lm_ops
from ..precision import FP
from .sweep_config import MESH_BACKEND

# The JAX package's serving configuration (bench.py:676-744): 16 draws of
# 128 points (tangent dim 776), 25 LM iterations, seed 0.
BATCH = 16
POINTS = 128
ITERATIONS = 25
# The block branch: 16 pairs of 680 points (dim 4088) hold ~6.8 GB of dense
# Jacobians, over DENSE_J_BUDGET_BYTES, so solve_pairs runs them on the
# block backend (deformable.py:851-852 of the JAX package).
BLOCK_POINTS = 680
BLOCK_ITERATIONS = 3

CAM = (458.654, 457.296, 367.215, 248.375, 0.0, 0.0, 0.0, 0.0)
DEGREE_BUCKET = 32
SCALE_PRIORS = (1.0, 1e6, 1.0, 1e6)
HYPER = dict(rep_w=1.0, arap_w=1e-4, depth_sigma=0.003, global_w=50.0, alpha=1.0, beta=1.0)


class ServingBatch(NamedTuple):
    datas: list  # PairData per pair
    states: list  # PairState per pair
    hyper: deformable.Hyper  # shared
    data: deformable.PairData  # stacked: leading pair axis
    state: deformable.PairState
    kept: list  # indices of the kept draws
    free: list  # per pair: the vertices whose frozen rotation is not determined (free_vertices)


def free_vertices(p1, p2, nbr, wcot) -> list:
    """Vertices whose frozen ARAP rotation the pair leaves undetermined: the
    weighted covariance that ``arap.compute_rotations`` fits (cot weights
    of the mesh edges times p1 and p2 edge vectors) has rank below 2, as at
    a vertex with one neighbour of non-zero weight. Any rotation about that
    edge fits, each package's SVD picks its own, and the pair's energy
    depends on the pick once its edges turn: such a pair is a different
    problem on each device. Returns their indices."""
    nbr = np.asarray(nbr)
    j = np.maximum(nbr, 0)
    w = np.asarray(wcot, np.float64) * (nbr >= 0)
    S = np.einsum("nk,nka,nkb->nab", w, p1[:, None] - p1[j], p2[:, None] - p2[j])
    sv = np.linalg.svd(S, compute_uv=False)
    return np.flatnonzero(sv[:, 1] <= 1e-9 * sv[:, 0]).tolist()


def draw_pairs(n_points: int = POINTS, batch: int = BATCH, seed: int = 0):
    """The numpy draws of ``bench.py:687-692``: a list of (p1, p2, kp)."""
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(batch):
        p1 = rng.normal(size=(n_points, 3)) * 0.05 + [0, 0, 0.2]
        p2 = p1 + rng.normal(scale=0.005, size=(n_points, 3))
        kp = rng.uniform(100, 600, size=(n_points, 2))
        draws.append((p1, p2, kp))
    return draws


def serving_batch(n_points: int = POINTS, batch: int = BATCH, seed: int = 0, device="cuda",
                  rotations=None) -> ServingBatch:
    """The serving fixture on ``device``: the draws whose mesh degree bucket
    is DEGREE_BUCKET, each as PairData and its initial PairState, and the
    shared Hyper. ``rotations`` ({kept pair: {vertex: 9 floats, row-major}})
    replaces the frozen rotations at exactly each pair's free vertices; it
    raises if it names other vertices."""
    dev = resolve_device(device)
    datas, states, kept, free = [], [], [], []
    eye = np.eye(3)
    for i, (p1, p2, kp) in enumerate(draw_pairs(n_points, batch, seed)):
        d = deformable.make_pair_data(
            kp1=kp, kp2=kp, depth1=p1[:, 2], depth2=p2[:, 2], valid=np.ones(n_points, bool),
            cam_params=np.asarray(CAM), T1w=(eye, np.zeros(3)), T2w=(eye, np.zeros(3)), p1=p1, p2=p2,
            mesh_backend=MESH_BACKEND, degree_bucket=DEGREE_BUCKET, scale_priors=SCALE_PRIORS, device=dev,
        )
        if d.nbr.shape[1] != DEGREE_BUCKET:
            continue
        fv = free_vertices(p1, p2, d.nbr.cpu().numpy(), d.wcot.cpu().numpy())
        if rotations is not None:
            pins = rotations.get(len(datas), {})
            if sorted(pins) != fv:
                raise ValueError(f"pair {len(datas)}: rotations for vertices {sorted(pins)}, free vertices {fv}")
            if pins:
                Ri = d.Ri.clone()
                Ri[fv] = torch.as_tensor([pins[v] for v in fv], dtype=FP, device=dev).reshape(-1, 3, 3)
                d = d._replace(Ri=Ri)
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=FP, device=dev)
        datas.append(d)
        states.append(deformable.PairState(
            p1=t(p1), p2=t(p2), s1=t(1.0), s2=t(1.0), Rg=torch.eye(3, dtype=FP, device=dev),
            tg=torch.zeros(3, dtype=FP, device=dev),
        ))
        kept.append(i)
        free.append(fv)
    hyper = deformable.Hyper(**{k: torch.tensor(v, dtype=FP, device=dev) for k, v in HYPER.items()})
    return ServingBatch(datas, states, hyper, lm_ops.stack(datas), lm_ops.stack(states), kept, free)
