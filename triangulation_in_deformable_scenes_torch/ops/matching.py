"""Descriptor matching as dense masked ops, and the windowed initial matcher.

Counterpart of ``triangulation_in_deformable_scenes_tpu/ops/matching.py``
(the reference's ``Modules/Matching/DescriptorMatching.cc``), function for
function. Descriptors are [N, 256] uint8 0/1 bits.

``search_for_initialization`` takes no backend switch: a CUDA tensor runs
the hand-written top-2 scan (``ops/match_scan.py``, kernel 3) and then the
ratio test and ``_one_to_one`` as torch ops; a CPU tensor runs the dense
plain path, the formula of ``matching.py:91-113``. The other four matchers
have no TPU kernel and stay plain torch on both devices.

``_one_to_one`` keeps JAX's ``<=`` (``matching.py:141``): two rows that claim
one column at an equal distance both keep it.
"""

from __future__ import annotations

import math

import torch

from . import match_scan

BIG = match_scan.BIG


def hamming_matrix(bits_a, bits_b):
    """[N1, 256] x [N2, 256] 0/1 bits -> [N1, N2] Hamming distances (f32).

    The count of positions where a is 1 and b is 0, plus the count where a
    is 0 and b is 1: two products of 0/1 matrices whose sums are integers
    <= 256, so exact in f32 in any summation order."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    return a @ (1.0 - b).T + (1.0 - a) @ b.T


def _window_d2(kp_a, kp_b):
    """Squared pixel distances [N1, N2]: dx*dx + dy*dy, each op rounded."""
    return ((kp_a[:, None, :] - kp_b[None, :, :]) ** 2).sum(dim=-1)


def _octave_ok(oct_row, oct_col):
    return (oct_col[None, :] >= (oct_row - 1)[:, None]) & (oct_col[None, :] <= (oct_row + 1)[:, None])


def _clip_octave(octave, n):
    return octave.clamp(0, n - 1).long()


def _best_second_best(Dm):
    """Per-row best index (first occurrence), best distance and second-best
    distance of a masked distance matrix (BIG on disallowed entries)."""
    best = torch.argmin(Dm, dim=1)
    best_d = Dm.gather(1, best[:, None])[:, 0]
    cols = torch.arange(Dm.shape[1], device=Dm.device)
    second_d = torch.where(cols[None, :] == best[:, None], torch.full_like(Dm, BIG), Dm).amin(dim=1)
    return best, best_d, second_d


def _one_to_one(best, best_d, ok, n2):
    """Resolve row->column conflicts by keeping the smallest distance (the
    C++ matchers' vnMatches21 bookkeeping). Returns (matches [N1] int32 with
    -1 for unmatched, n_matches)."""
    best_safe = torch.where(ok, best.long(), torch.full_like(best.long(), n2))
    cand = torch.where(ok, best_d, torch.full_like(best_d, BIG))
    col_min = torch.full((n2 + 1,), BIG, dtype=best_d.dtype, device=best_d.device)
    col_min = col_min.scatter_reduce(0, best_safe, cand, reduce="amin", include_self=True)
    keep = ok & (best_d <= col_min[best_safe])
    matches = torch.where(keep, best.long(), torch.full_like(best.long(), -1)).to(torch.int32)
    return matches, keep.sum()


def search_for_initialization(
    kp_ref,
    desc_ref,
    octave_ref,
    valid_ref,
    kp_cur,
    desc_cur,
    octave_cur,
    valid_cur,
    scale_factors,
    th: float = 50.0,
    window_factor: float = 50.0,
    ratio: float = 0.9,
    max_octave: int = 0,
):
    """Returns (matches [N1] int32 with -1 for unmatched, n_matches).

    Parity with ``searchForInitializaion`` (DescriptorMatching.cc:39-99):
    only reference keys with octave <= max_octave participate; candidates
    must lie within ``window_factor * scale_factor[octave]`` pixels and in
    octave [o-1, o+1]."""
    r2, row_ok = match_scan.row_meta(kp_ref, octave_ref, valid_ref, scale_factors, window_factor, max_octave)
    best_d, best, second_d = match_scan.match_scan(
        kp_ref, r2, octave_ref, row_ok, desc_ref, kp_cur, octave_cur, valid_cur, desc_cur
    )
    ok = (best_d <= th) & (best_d < second_d * ratio)
    return _one_to_one(best, best_d, ok, kp_cur.shape[0])


def guided_matching(
    proj_uv,
    mp_desc,
    mp_octave,
    mp_valid,
    kp_cur,
    desc_cur,
    octave_cur,
    valid_cur,
    scale_factors,
    th: float = 50.0,
    window_factor: float = 1.0,
    ratio: float = 0.9,
):
    """``guidedMatching`` (DescriptorMatching.cc:101-162), batched: radius
    15 * window_factor * scale_factor[octave], octave within one of the
    point's last observation."""
    D = hamming_matrix(mp_desc, desc_cur)
    radius = 15.0 * window_factor * scale_factors[_clip_octave(mp_octave, len(scale_factors))]
    d2 = _window_d2(proj_uv, kp_cur)
    allowed = (
        (d2 <= (radius**2)[:, None]) & _octave_ok(mp_octave, octave_cur)
        & mp_valid[:, None] & valid_cur[None, :]
    )
    Dm = torch.where(allowed, D, torch.full_like(D, BIG))
    best, best_d, second_d = _best_second_best(Dm)
    ok = (best_d <= th) & (best_d < second_d * ratio)
    return _one_to_one(best, best_d, ok, Dm.shape[1])


def search_with_projection(
    proj_uv,
    mp_desc,
    mp_valid,
    view_cos,
    dist,
    min_dist_inv,
    max_dist_inv,
    kp_cur,
    desc_cur,
    octave_cur,
    valid_cur,
    scale_factors,
    th: float = 100.0,
    ratio: float = 0.9,
):
    """``searchWithProjection`` (DescriptorMatching.cc:164-254), batched:
    view-angle gate (cos >= 0.5), distance within the point's
    scale-invariance range, octave predicted from the distance, radius 2.5x
    when nearly frontal and 4x else."""
    n_scales = len(scale_factors)
    if n_scales > 1:
        log_sf = torch.log(scale_factors[1])
    else:
        log_sf = torch.ones((), dtype=scale_factors.dtype, device=scale_factors.device)
    pred_octave = torch.clamp(
        torch.ceil(torch.log(max_dist_inv / torch.clamp(dist, min=1e-12)) / log_sf), 0, n_scales - 1
    ).to(torch.int32)
    radius = scale_factors[pred_octave.long()] * torch.where(
        view_cos > 0.998, torch.full_like(view_cos, 2.5), torch.full_like(view_cos, 4.0)
    )
    gate = mp_valid & (view_cos >= 0.5) & (dist >= min_dist_inv) & (dist <= max_dist_inv)
    D = hamming_matrix(mp_desc, desc_cur)
    d2 = _window_d2(proj_uv, kp_cur)
    allowed = (d2 <= (radius**2)[:, None]) & _octave_ok(pred_octave, octave_cur) & gate[:, None] & valid_cur[None, :]
    Dm = torch.where(allowed, D, torch.full_like(D, BIG))
    best, best_d, second_d = _best_second_best(Dm)
    ok = (best_d <= th) & (best_d < second_d * ratio)
    return _one_to_one(best, best_d, ok, Dm.shape[1])


def _unit(x):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def search_for_triangulation(
    desc1,
    desc2,
    rays1,
    rays2,
    E,
    free1,
    free2,
    th: float = 50.0,
    epipolar_th: float = 0.002,
):
    """``searchForTriangulation`` (DescriptorMatching.cc:255-328), batched:
    epipolar-constrained matching between two keyframes over features not
    yet associated with a map point, with the reference's hard 50 cap; the
    C++ version's ``vbMatched2[bestDist]`` index bug is not reproduced."""
    D = hamming_matrix(desc1, desc2)
    r1h = _unit(rays1 @ E.T)
    r2n = _unit(rays2)
    ang = torch.arccos(torch.clamp(r1h @ r2n.T, -1.0, 1.0))
    epi_ok = torch.abs(math.pi / 2 - ang) < epipolar_th
    allowed = (D <= 50.0) & epi_ok & free1[:, None] & free2[None, :]
    Dm = torch.where(allowed, D, torch.full_like(D, BIG))
    best, best_d, _ = _best_second_best(Dm)
    ok = best_d < th
    return _one_to_one(best, best_d, ok, Dm.shape[1])


def fuse_matching(
    proj_uv,
    mp_desc,
    mp_octave,
    mp_valid,
    kp_kf,
    desc_kf,
    octave_kf,
    valid_kf,
    scale_factors,
    th: float = 50.0,
    ratio: float = 0.9,
):
    """Matching stage of ``fuse`` (DescriptorMatching.cc:330-427): radius
    2.5 * scale_factor[octave], no one-to-one pass."""
    D = hamming_matrix(mp_desc, desc_kf)
    radius = 2.5 * scale_factors[_clip_octave(mp_octave, len(scale_factors))]
    d2 = _window_d2(proj_uv, kp_kf)
    allowed = (d2 <= (radius**2)[:, None]) & _octave_ok(mp_octave, octave_kf) & mp_valid[:, None] & valid_kf[None, :]
    Dm = torch.where(allowed, D, torch.full_like(D, BIG))
    best, best_d, second_d = _best_second_best(Dm)
    ok = (best_d <= th) & (best_d < second_d * ratio)
    matches = torch.where(ok, best, torch.full_like(best, -1)).to(torch.int32)
    return matches, ok.sum()


def essential_from_pose(R12, t12):
    """E = [t]x R for the relative transform T12 (``Geometry.cc:239-256``)."""
    z = torch.zeros((), dtype=R12.dtype, device=R12.device)
    t = t12.to(R12.dtype)
    tx = torch.stack([
        torch.stack([z, -t[2], t[1]]),
        torch.stack([t[2], z, -t[0]]),
        torch.stack([-t[1], t[0], z]),
    ])
    return tx @ R12


def epipolar_inliers(E, rays_ref, rays_cur, th):
    """Angular epipolar test (``MonocularMapInitializer::computeScoreAndInliers``):
    |pi/2 - angle(E r1, r2)| < th."""
    r1h = _unit(rays_ref @ E.T)
    r2n = _unit(rays_cur)
    ang = torch.arccos(torch.clamp((r1h * r2n).sum(dim=-1), -1.0, 1.0))
    return torch.abs(math.pi / 2 - ang) < th
