"""Mesh of the reference: Qhull's 2D Delaunay of the keyframe-1 points'
(x, y), padded neighbour lists, cotangent edge weights and surface area
(numpy, float64)."""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import numpy as np
from scipy.spatial import Delaunay


class Mesh(NamedTuple):
    nbr: np.ndarray  # [N, K] int64, -1 padded
    weights: np.ndarray  # [N, K] cot weight of each directed edge
    n_triangles: int
    surface_area: float


def cot_weights(vertices, triangles):
    """(i < j) -> mean over the edge's 1-2 incident triangles of the
    cotangent at the opposite vertex, clamped below at 0."""
    opposite = defaultdict(list)
    for t in triangles:
        i, j, k = int(t[0]), int(t[1]), int(t[2])
        opposite[(min(i, j), max(i, j))].append(k)
        opposite[(min(j, k), max(j, k))].append(i)
        opposite[(min(i, k), max(i, k))].append(j)
    out = {}
    for (i, j), opp in opposite.items():
        ws = 0.0
        for v in opp:
            a = vertices[i] - vertices[v]
            b = vertices[j] - vertices[v]
            ws += float(np.dot(a, b) / np.linalg.norm(np.cross(a, b)))
        out[(i, j)] = max(ws / len(opp), 0.0)
    return out


def build_mesh(vertices3d, degree_multiple: int = 32) -> Mesh:
    """Mesh of ``vertices3d`` [N, 3]; K is the largest degree rounded up to
    ``degree_multiple``; neighbours of a vertex in ascending order."""
    v = np.asarray(vertices3d, dtype=np.float64)
    tris = Delaunay(np.ascontiguousarray(v[:, :2]), qhull_options="Qbb Qt").simplices.astype(np.int32)
    adj = [set() for _ in range(len(v))]
    for t in tris:
        i, j, k = int(t[0]), int(t[1]), int(t[2])
        adj[i].update((j, k))
        adj[j].update((i, k))
        adj[k].update((i, j))
    w = cot_weights(v, tris)
    max_deg = max(len(a) for a in adj)
    K = max(-(-max_deg // degree_multiple) * degree_multiple, degree_multiple)
    nbr = np.full((len(v), K), -1, dtype=np.int64)
    wmat = np.zeros((len(v), K))
    for i, nb in enumerate(adj):
        for slot, j in enumerate(sorted(nb)):
            nbr[i, slot] = j
            wmat[i, slot] = w[(min(i, j), max(i, j))]
    a, b, c = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    area = float(0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1).sum())
    return Mesh(nbr=nbr, weights=wmat, n_triangles=int(len(tris)), surface_area=area)
