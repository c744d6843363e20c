"""Classic bundle adjustment: full BA, pose-only, and local BA.

Counterpart of ``triangulation_in_deformable_scenes_tpu/models/bundle_adjustment.py``
(the reference's Mini-SLAM optimizers, ``g2oBundleAdjustment.cc:38-444``),
on the same LM loop as the deformable solver:

- ``bundle_adjustment``: joint poses and points, Huber delta sqrt(5.99),
  fixed poses masked out of the linearization, 20 LM iterations (``:146-160``);
- ``pose_only_optimization``: 4 rounds of 10 iterations on the 6x6 pose
  block with chi2 > 5.991 outliers deactivated between rounds (``:163-209``);
- ``local_bundle_adjustment``: BA over a keyframe's covisibility
  neighbourhood with the boundary keyframes and keyframe 0 fixed, then
  removal of the observations with chi2 > 5.991 (``:212-270``), on the
  port's ``pipeline/worldmap.WorldMap``.

The tangent is [poses (6K), points (3M)]. Each damped solve goes through
``ops/lm.lm_optimize``, so on the card it is kernel 1 (dim 6 for the pose
block). JAX sums the per-observation [9, 9] blocks into H with ``.at[].add``;
on the card a scatter-add sums with atomics in a varying order, so here the
local Jacobians are written into a dense J [2E, dim] (each row has 9
distinct columns, so every entry is written once) and H = J^T J, g = J^T r:
repeated runs give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..device import resolve_device
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import lm as lm_ops
from ..precision import FP, TINY

HUBER_BA = float(np.sqrt(5.99))  # thHuber2D (g2oBundleAdjustment.cc:57)
CHI2_OUTLIER = 5.991


class BAData(NamedTuple):
    obs_kf: torch.Tensor  # [E] int64 keyframe index per observation
    obs_mp: torch.Tensor  # [E] int64 point index
    obs_uv: torch.Tensor  # [E, 2]
    obs_info: torch.Tensor  # [E] invSigma2
    obs_valid: torch.Tensor  # [E] bool
    cam_params: torch.Tensor
    fixed_pose: torch.Tensor  # [K] bool


class BAState(NamedTuple):
    R: torch.Tensor  # [K, 3, 3] world-to-camera
    t: torch.Tensor  # [K, 3]
    points: torch.Tensor  # [M, 3]


def _apply_delta(state: BAState, delta: torch.Tensor) -> BAState:
    K = state.R.shape[0]
    M = state.points.shape[0]
    dxi = delta[: 6 * K].reshape(K, 6)
    dp = delta[6 * K : 6 * K + 3 * M].reshape(M, 3)
    dR, dt = lie.se3_exp(dxi)
    R = dR @ state.R
    t = torch.einsum("kij,kj->ki", dR, state.t) + dt
    return BAState(R=R, t=t, points=state.points + dp)


def _errors(cam_kind, data: BAData, state: BAState):
    p = state.points[data.obs_mp]
    R = state.R[data.obs_kf]
    t = state.t[data.obs_kf]
    pc = torch.einsum("eij,ej->ei", R, p) + t
    return data.obs_uv - cam_ops.project(cam_kind, data.cam_params, pc)


def _chi2(cam_kind, data, state):
    e = _errors(cam_kind, data, state)
    return torch.sum(e * e, dim=-1) * data.obs_info


def _huber(chi2, delta):
    d2 = delta * delta
    sqrt_c = torch.sqrt(torch.clamp(chi2, min=TINY))
    rho = torch.where(chi2 <= d2, chi2, 2.0 * delta * sqrt_c - d2)
    drho = torch.where(chi2 <= d2, torch.ones_like(chi2), delta / sqrt_c)
    return rho, drho


def _cost(cam_kind, data, state, robust):
    chi2 = _chi2(cam_kind, data, state)
    if robust:
        chi2, _ = _huber(chi2, HUBER_BA)
    return torch.sum(torch.where(data.obs_valid, chi2, torch.zeros_like(chi2)))


def _build_system(cam_kind, data: BAData, state: BAState, robust):
    """Gauss-Newton (H, g) with the robust weights frozen at ``state``
    (``bundle_adjustment.py:98-143``): per-observation local Jacobians
    [2, 9] over (pose xi, point dp) by forward-mode AD, written into J."""
    K = state.R.shape[0]
    M = state.points.shape[0]
    dim = 6 * K + 3 * M
    E = data.obs_kf.shape[0]
    dtype, dev = state.points.dtype, state.points.device

    chi2 = _chi2(cam_kind, data, state)
    drho = _huber(chi2, HUBER_BA)[1] if robust else torch.ones_like(chi2)
    w = torch.sqrt(drho * data.obs_info) * data.obs_valid.to(dtype)
    # Fixed poses contribute no pose derivative.
    pose_free = (~data.fixed_pose[data.obs_kf]).to(dtype)

    R0 = state.R[data.obs_kf]
    t0 = state.t[data.obs_kf]
    p0 = state.points[data.obs_mp]

    def local(x):  # x [E, 9] -> weighted residuals [E, 2]
        dR, dt = lie.se3_exp(x[:, :6] * pose_free[:, None])
        Rk = dR @ R0
        tk = torch.einsum("eij,ej->ei", dR, t0) + dt
        pc = torch.einsum("eij,ej->ei", Rk, p0 + x[:, 6:9]) + tk
        return w[:, None] * (data.obs_uv - cam_ops.project(cam_kind, data.cam_params, pc))

    x0 = torch.zeros((E, 9), dtype=dtype, device=dev)
    # One JVP per local coordinate (column k of every observation's
    # Jacobian), vmapped over the 9 coordinates.
    basis = torch.eye(9, dtype=dtype, device=dev)[:, None, :].expand(9, E, 9)
    L = vmap(lambda v: jvp(local, (x0,), (v,))[1])(basis).permute(1, 2, 0)  # [E, 2, 9]
    r = local(x0)

    idx_pose = 6 * data.obs_kf[:, None] + torch.arange(6, device=dev)[None, :]
    idx_pt = 6 * K + 3 * data.obs_mp[:, None] + torch.arange(3, device=dev)[None, :]
    idx = torch.cat([idx_pose, idx_pt], dim=-1)  # [E, 9], distinct within a row
    J = torch.zeros((2 * E, dim), dtype=dtype, device=dev)
    J.scatter_(1, idx.repeat_interleave(2, dim=0), L.reshape(2 * E, 9))
    return J.T @ J, J.T @ r.reshape(-1)


def bundle_adjustment(
    cam_kind: str,
    data: BAData,
    state0: BAState,
    n_iterations: int = 20,
    robust: bool = True,
) -> lm_ops.LMResult:
    """Full BA (``bundleAdjustment``, g2oBundleAdjustment.cc:38-138), on the
    device of ``state0``."""
    return lm_ops.lm_optimize(
        build_system=lambda s: _build_system(cam_kind, data, s, robust),
        robust_cost=lambda s: _cost(cam_kind, data, s, robust),
        apply_delta=_apply_delta,
        state0=state0,
        n_iterations=n_iterations,
    )


def pose_only_optimization(cam_kind, cam_params, points, kps, inv_sigma2, R0, t0, valid=None, device="cuda"):
    """``poseOnlyOptimization`` (g2oBundleAdjustment.cc:140-243): one camera
    pose against fixed points, 4 rounds of 10 LM iterations on the 6x6 pose
    block with chi2 culling at 5.991 between rounds, on ``device``. Takes
    and returns numpy arrays: (R, t, inlier_mask)."""
    dev = resolve_device(device)
    n = len(points)
    valid = np.ones(n, dtype=bool) if valid is None else np.asarray(valid, dtype=bool)
    t_ = lambda x: torch.as_tensor(np.asarray(x), dtype=FP, device=dev)
    inliers = torch.as_tensor(valid, device=dev)
    data = BAData(
        obs_kf=torch.zeros(n, dtype=torch.int64, device=dev),
        obs_mp=torch.arange(n, device=dev),
        obs_uv=t_(kps),
        obs_info=t_(inv_sigma2),
        obs_valid=inliers,
        cam_params=t_(cam_params),
        fixed_pose=torch.zeros(1, dtype=torch.bool, device=dev),
    )
    state = BAState(R=t_(R0)[None], t=t_(t0)[None], points=t_(points))
    zeros = torch.zeros(3 * n, dtype=FP, device=dev)

    for _ in range(4):
        active = data._replace(obs_valid=inliers)

        def build(s, active=active):
            H, g = _build_system(cam_kind, active, s, robust=True)
            return H[:6, :6], g[:6]  # the points stay fixed

        res = lm_ops.lm_optimize(
            build,
            lambda s, active=active: _cost(cam_kind, active, s, robust=True),
            lambda s, delta6: _apply_delta(s, torch.cat([delta6, zeros])),
            state,
            n_iterations=10,
        )
        state = res.state
        chi2 = _chi2(cam_kind, data, state).cpu().numpy()
        inliers = torch.as_tensor(valid & (chi2 <= CHI2_OUTLIER), device=dev)

    return state.R[0].cpu().numpy(), state.t[0].cpu().numpy(), inliers.cpu().numpy()


def local_bundle_adjustment(world_map, kf_id: int, cam_kind: str, cam_params, n_iterations=20, device="cuda"):
    """``localBundleAdjustment`` (g2oBundleAdjustment.cc:245-444): BA over
    the covisibility neighbourhood of ``kf_id`` on ``device``, boundary
    keyframes and keyframe 0 fixed, then removal of the observations whose
    chi2 exceeds 5.991.

    Mutates ``world_map`` (poses, point positions, culled observations).
    Returns (n_edges, n_removed).
    """
    dev = resolve_device(device)
    local_mps, local_kfs, fixed_kfs = world_map.local_map_of_keyframe(kf_id)
    kf_ids = sorted(local_kfs) + sorted(fixed_kfs)
    kf_index = {k: i for i, k in enumerate(kf_ids)}
    mp_ids = sorted(local_mps)
    mp_index = {m: i for i, m in enumerate(mp_ids)}

    obs = []
    for m in mp_ids:
        for k, feat_idx in world_map.mp_obs[m].items():
            if k in kf_index:
                obs.append((kf_index[k], mp_index[m], k, m, feat_idx))
    if not obs:
        return 0, 0

    kfs = [world_map.keyframes[k] for k in kf_ids]
    sf = kfs[0].scale_factor
    uv = np.array([kfs[o[0]].kp[o[4]] for o in obs])
    info = np.array([1.0 / sf ** (2 * int(kfs[o[0]].octave[o[4]])) for o in obs])
    t_ = lambda x: torch.as_tensor(np.asarray(x), dtype=FP, device=dev)
    fixed = [(k in fixed_kfs) or (k == 0) for k in kf_ids]

    data = BAData(
        obs_kf=torch.as_tensor([o[0] for o in obs], dtype=torch.int64, device=dev),
        obs_mp=torch.as_tensor([o[1] for o in obs], dtype=torch.int64, device=dev),
        obs_uv=t_(uv),
        obs_info=t_(info),
        obs_valid=torch.ones(len(obs), dtype=torch.bool, device=dev),
        cam_params=t_(cam_params),
        fixed_pose=torch.as_tensor(fixed, device=dev),
    )
    state0 = BAState(
        R=t_(np.stack([kf.R_cw for kf in kfs])),
        t=t_(np.stack([kf.t_cw for kf in kfs])),
        points=t_(np.stack([world_map.map_points[m].position for m in mp_ids])),
    )
    res = bundle_adjustment(cam_kind, data, state0, n_iterations=n_iterations)

    R, t, points = (x.cpu().numpy() for x in res.state)
    for i, k in enumerate(kf_ids):
        if not fixed[i]:
            world_map.keyframes[k].R_cw = R[i]
            world_map.keyframes[k].t_cw = t[i]
    for m, i in mp_index.items():
        world_map.map_points[m].position = points[i]

    chi2 = _chi2(cam_kind, data, res.state).cpu().numpy()
    n_removed = 0
    for o, c in zip(obs, chi2):
        if c > CHI2_OUTLIER:
            world_map.remove_observation(o[2], o[3])
            n_removed += 1
    return len(obs), n_removed
