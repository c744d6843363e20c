"""The landmark-sharding fixture: one random pair at the JAX package's
scaled size.

``bench.py:889-948`` (``_SCALING_SNIPPET``, run by
``virtual_scaling_check(n=16384)`` at ``:950``) draws n points from
``np.random.default_rng(0)``: ``p1 ~ N(0, 0.05^2) + [0, 0, 0.2]`` m,
``p2 = p1 + N(0, 0.005^2)``, pixels ``kp ~ U(100, 600)`` (the same in both
frames), identity poses, the intrinsics (458, 457, 367, 248), no
depth-scale priors, ``arap_w`` 1e-4, and solves 5 LM iterations at
``cg_iters`` 32 (``CG_RTOL`` 1e-2). These are the serving fixture's draws
(``harness/serving.draw_pairs``) at one pair of n points.

The mesh is built with the scipy backend: for points in general position
the Delaunay triangulation is unique, so it is the one ``bench.py`` builds.
Some vertices keep a single weighted mesh edge, whose frozen rotation the
pair leaves free (``serving.free_vertices``; 66 at 16,384 points), and each
package's SVD picks its own there: ``rotations`` ({vertex: 9 floats,
row-major}) pins another package's pick at exactly those vertices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import deformable
from ..precision import FP
from .serving import draw_pairs, free_vertices
from .sweep_config import MESH_BACKEND

POINTS = 16384
ITERATIONS = 5
CG_ITERS = 32
CAM = (458.0, 457.0, 367.0, 248.0, 0.0, 0.0, 0.0, 0.0)
HYPER = dict(rep_w=1.0, arap_w=1e-4, depth_sigma=0.003, global_w=50.0, alpha=1.0, beta=1.0)


def scaling_pair(n_points: int = POINTS, seed: int = 0, device="cuda", rotations=None):
    """(data, state, hyper, free vertices) of the scaled pair on ``device``."""
    dev = resolve_device(device)
    p1, p2, kp = draw_pairs(n_points, 1, seed)[0]
    eye = np.eye(3)
    data = deformable.make_pair_data(
        kp1=kp, kp2=kp, depth1=p1[:, 2], depth2=p2[:, 2], valid=np.ones(n_points, bool),
        cam_params=np.asarray(CAM), T1w=(eye, np.zeros(3)), T2w=(eye, np.zeros(3)), p1=p1, p2=p2,
        mesh_backend=MESH_BACKEND, device=dev,
    )
    fv = free_vertices(p1, p2, data.nbr.cpu().numpy(), data.wcot.cpu().numpy())
    if rotations is not None:
        if sorted(rotations) != fv:
            raise ValueError(f"rotations for vertices {sorted(rotations)}, free vertices {fv}")
        Ri = data.Ri.clone()
        Ri[fv] = torch.as_tensor([rotations[v] for v in fv], dtype=FP, device=dev).reshape(-1, 3, 3)
        data = data._replace(Ri=Ri)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=FP, device=dev)
    state = deformable.PairState(p1=t(p1), p2=t(p2), s1=t(1.0), s2=t(1.0), Rg=t(eye), tg=t(np.zeros(3)))
    hyper = deformable.Hyper(**{k: t(v) for k, v in HYPER.items()})
    return data, state, hyper, fv
