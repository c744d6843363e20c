"""Pose-free two-view initialisation: batched 8-point, RANSAC, E decomposition.

Counterpart of ``triangulation_in_deformable_scenes_tpu/ops/epipolar.py``
(the reference's ``MonocularMapInitializer.cc:119-279``), function for
function: the 8-point ``computeE`` on bearing rays, ``decomposeE``,
``reconstructCameras`` with the cheirality-voted sign of t, a fixed
8-iteration Lloyd k-means over the reference keypoints, and the
cluster-sampled RANSAC (17 hypotheses, one sample per cluster, every
hypothesis scored against every match, the first best wins).

Random draws. JAX draws the k-means seeds and the samples from
``jax.random`` (key 10 in the sequence pipeline), which torch cannot
reproduce. Here they come from an explicit ``torch.Generator`` (the
k-means seeds by ``torch.multinomial`` without replacement, weighted to the
valid points; the samples uniform over each cluster's valid members, over
all valid points for an empty cluster), or are handed in: ``init_idx`` [k]
(the k-means seeds) and ``sample_idx`` [B, k] (the minimal sets; with them
the k-means is not needed and is skipped). Handed the draws JAX made, the
port gives JAX's hypotheses.

SVD conventions. An SVD fixes its singular vectors only up to sign, and
LAPACK (both packages on the CPU) and cuSOLVER may choose differently. E
from the 8-point solve is therefore defined up to sign. The decomposition
does not depend on the choice: flipping the third left and right singular
vectors swaps the two det-fixed rotations ``U W^T V^T`` and ``U W V^T``,
the rotation kept is the one with the larger trace, and the sign of t is
voted. Only exact ties depend on it: equal traces keep the first rotation
and a vote of exactly zero keeps ``U[:, 2]`` as the SVD returned it.
"""

from __future__ import annotations

import torch

from ..precision import FP, TINY
from .matching import epipolar_inliers


def compute_essential_8pt(ref_rays, cur_rays):
    """Batched 8-point algorithm on unit bearing rays [..., 8, 3] -> E
    [..., 3, 3]: rows ``ref_i * cur_i[c]`` for c in (0, 1, 2), the right
    singular vector of the smallest singular value reshaped row-major, the
    rank-2 projection diag(1, 1, 0) and the reference's trailing negation
    (``epipolar.py:31-51``)."""
    A = torch.cat([ref_rays * cur_rays[..., 0:1], ref_rays * cur_rays[..., 1:2], ref_rays * cur_rays[..., 2:3]],
                  dim=-1)  # [..., 8, 9]
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    E = Vt[..., 8, :].reshape(*A.shape[:-2], 3, 3)
    U, s, Vt3 = torch.linalg.svd(E)
    s2 = torch.zeros_like(s)
    s2[..., :2] = 1.0
    return -(U @ (s2[..., :, None] * Vt3))


def decompose_essential(E):
    """E -> (R1, R2, t): the two det-fixed rotations ``U W^T V^T`` and
    ``U W V^T`` and t = U's third column, normalised (``epipolar.py:54-67``)."""
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W.T @ Vt
    R2 = U @ W @ Vt
    R1 = R1 * torch.where(torch.linalg.det(R1) < 0, -1.0, 1.0)[..., None, None]
    R2 = R2 * torch.where(torch.linalg.det(R2) < 0, -1.0, 1.0)[..., None, None]
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=TINY)
    return R1, R2, t


def reconstruct_cameras(E, rays1, rays2):
    """Relative pose (R, t) of camera 2 from E and matched rays
    (``epipolar.py:70-85``): the rotation with the larger trace, t's sign by
    the vote ``sum(sign((R r1 - r2) . (r2 - t)))``, flipped when negative."""
    R1, R2, t = decompose_essential(E)
    tr1 = R1.diagonal(dim1=-2, dim2=-1).sum(-1)
    tr2 = R2.diagonal(dim1=-2, dim2=-1).sum(-1)
    R = torch.where((tr2 > tr1)[..., None, None], R2, R1)
    moved = torch.einsum("...ij,...nj->...ni", R, rays1) - rays2
    away = torch.sign((moved * (rays2 - t[..., None, :])).sum(-1)).sum(-1)
    t = torch.where((away < 0)[..., None], -t, t)
    return R, t


def _kmeans(xy, valid, k, iters, generator=None, init_idx=None):
    """Fixed-iteration Lloyd k-means over the valid positions xy [N, 2];
    returns labels [N] (``epipolar.py:88-113``). Invalid points get a label
    but never move a centre; an empty cluster keeps its centre; ties go to
    the first centre. Seeds: ``init_idx`` [k], else k valid points drawn
    without replacement from ``generator``."""
    vm = valid.to(xy.dtype)
    if init_idx is None:
        init_idx = torch.multinomial(vm / torch.clamp(vm.sum(), min=1.0), k, replacement=False,
                                     generator=generator)
    centers = xy[init_idx.to(xy.device)]
    for _ in range(iters):
        d2 = ((xy[:, None, :] - centers[None, :, :]) ** 2).sum(-1)  # [N, k]
        onehot = torch.nn.functional.one_hot(d2.argmin(-1), k).to(xy.dtype) * vm[:, None]
        counts = onehot.sum(0)
        sums = onehot.T @ xy
        centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers)
    return ((xy[:, None, :] - centers[None, :, :]) ** 2).sum(-1).argmin(-1)


def ransac_essential(kp_ref, ref_rays, cur_rays, valid, generator=None, epipolar_th: float = 0.01,
                     n_hypotheses: int = 17, k_clusters: int = 8, init_idx=None, sample_idx=None):
    """Cluster-sampled RANSAC over batched 8-point hypotheses
    (``epipolar.py:116-162``). ``kp_ref`` [N, 2] pixels (for the clusters),
    rays [N, 3] unit bearings, ``valid`` [N] bool. Returns (E [3, 3],
    inliers [N] bool, n_inliers); the first hypothesis with the most
    inliers wins. ``sample_idx`` [B, k] hands in the minimal sets, else
    they are drawn from ``generator`` (see the module docstring)."""
    if sample_idx is None:
        labels = _kmeans(kp_ref.to(FP), valid, k_clusters, 8, generator, init_idx)
        member = (labels[None, :] == torch.arange(k_clusters, device=labels.device)[:, None]) & valid[None, :]
        member = torch.where(member.any(1, keepdim=True), member, valid[None, :].expand_as(member))
        probs = member.to(FP)[None].expand(n_hypotheses, -1, -1).reshape(n_hypotheses * k_clusters, -1)
        sample_idx = torch.multinomial(probs, 1, generator=generator).reshape(n_hypotheses, k_clusters)
    sample_idx = sample_idx.to(ref_rays.device)
    E = compute_essential_8pt(ref_rays[sample_idx], cur_rays[sample_idx])  # [B, 3, 3]
    inliers = torch.stack([epipolar_inliers(Eb, ref_rays, cur_rays, epipolar_th) & valid for Eb in E])
    scores = inliers.to(torch.int32).sum(-1)
    best = int(torch.argmax(scores))  # the first maximum, as jnp.argmax
    return E[best], inliers[best], scores[best]


def initialize_pose_free(kp_ref, ref_rays, cur_rays, valid, generator=None, epipolar_th: float = 0.01,
                         init_idx=None, sample_idx=None):
    """RANSAC E -> (R21, t21, inliers, n_inliers), the pose taking camera-1
    to camera-2 coordinates up to the monocular scale of t; the cheirality
    vote runs over the inliers only (``epipolar.py:165-175``)."""
    E, inliers, n_inliers = ransac_essential(kp_ref, ref_rays, cur_rays, valid, generator, epipolar_th,
                                             init_idx=init_idx, sample_idx=sample_idx)
    w = inliers.to(ref_rays.dtype)[:, None]
    R, t = reconstruct_cameras(E, ref_rays * w, cur_rays * w)
    return R, t, inliers, n_inliers
