"""The bundle-adjustment scenes of the JAX package's tests, for the port.

``make_scene`` and ``make_map`` follow ``tests/test_worldmap_ba.py:17-48``:
points ``N(0, diag(0.08, 0.06, 0.02)^2) + [0, 0, 0.6]`` m from
``default_rng(seed)``, keyframe k at ``(-0.1 + 0.1 k, 0.02 k, 0)`` looking at
the points' mean (that position is also the pose's t, as the test takes it),
KB8 observations with optional pixel noise; the map holds every point in
every keyframe. ``ba_problem`` and ``pose_only_problem`` are the test's full
BA and pose-only set-ups (the first two poses fixed; 2 mm perturbations from
``default_rng(3)``; a pose perturbed from ``default_rng(4)`` and gross
outliers of +80 px) at any size, as numpy arrays, so that both packages take
the same inputs. The rotations and projections are computed in f32 by the
port's ops on the CPU, as the JAX test computes them in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import camera, lie
from ..pipeline.worldmap import KeyFrameData, WorldMap
from ..precision import FP

CAM = np.array([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0], dtype=np.float64)


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=FP)


def make_scene(n_pts=40, n_kf=3, seed=0, noise_px=0.0):
    """(points [n_pts, 3], [(R_cw, t_cw)] per keyframe, [uv [n_pts, 2]] per
    keyframe)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_pts, 3)) * [0.08, 0.06, 0.02] + [0, 0, 0.6]
    poses = []
    for k in range(n_kf):
        c = np.array([-0.1 + 0.1 * k, 0.02 * k, 0.0])
        poses.append((lie.look_at(_f32(c), _f32(pts.mean(0))).numpy(), c))
    obs = []
    for R, t in poses:
        uv = camera.kb8_project(_f32(CAM), _f32(pts @ R.T + t)).numpy()
        obs.append(uv + rng.normal(scale=noise_px, size=uv.shape) if noise_px else uv)
    return pts, poses, obs


def make_map(pts, poses, obs) -> tuple:
    """A WorldMap holding every point in every keyframe; (map, point ids)."""
    rng = np.random.default_rng(7)
    wm = WorldMap(min_common_obs=5)
    descs = rng.integers(0, 2, size=(len(pts), 256)).astype(np.int8)
    mp_ids = [wm.insert_map_point(p) for p in pts]
    for k, ((R, t), uv) in enumerate(zip(poses, obs)):
        kf = KeyFrameData(
            kf_id=k, R_cw=R, t_cw=t, kp=uv, octave=np.zeros(len(pts), dtype=int),
            desc=descs + (rng.integers(0, 2, size=descs.shape) * (rng.random(descs.shape) < 0.02)).astype(np.int8) % 2,
        )
        wm.insert_keyframe(kf)
        for i, m in enumerate(mp_ids):
            wm.add_observation(k, m, i, update_stats=False)
    for m in mp_ids:
        wm.update_orientation_and_descriptor(m)
    return wm, mp_ids


def ba_problem(n_pts=40, n_kf=3, seed=0, noise_px=0.0, n_fixed=2):
    """Full BA as ``test_bundle_adjustment_reduces_noise`` sets it up: the
    BAData and BAState fields as numpy arrays, and the true points."""
    pts, poses, obs = make_scene(n_pts, n_kf, seed, noise_px)
    rng = np.random.default_rng(3)
    E = n_kf * n_pts
    data = dict(
        obs_kf=np.repeat(np.arange(n_kf), n_pts), obs_mp=np.tile(np.arange(n_pts), n_kf),
        obs_uv=np.concatenate(obs, axis=0), obs_info=np.ones(E), obs_valid=np.ones(E, dtype=bool),
        cam_params=CAM, fixed_pose=np.arange(n_kf) < n_fixed,
    )
    state = dict(
        R=np.stack([R for R, _ in poses]),
        t=np.stack([t for _, t in poses]) + rng.normal(scale=2e-3, size=(n_kf, 3)) * [0, 0, 1],
        points=pts + rng.normal(scale=2e-3, size=pts.shape),
    )
    return data, state, pts


def pose_only_problem(n_pts=40, n_outliers=5, seed=0):
    """Pose-only as ``test_pose_only_optimization_recovers_pose_and_culls_outliers``
    sets it up: (points, uv with the first ``n_outliers`` moved +80 px,
    perturbed R0, t0, true R, t)."""
    pts, poses, obs = make_scene(n_pts, 1, seed)
    R, t = poses[0]
    uv = obs[0].copy()
    uv[:n_outliers] += 80.0
    rng = np.random.default_rng(4)
    xi = np.concatenate([rng.normal(scale=0.01, size=3), rng.normal(scale=0.005, size=3)])
    dR, dt = (x.numpy() for x in lie.se3_exp(_f32(xi)))
    return pts, uv, dR @ R, dR @ t + dt, R, t
