"""Parity of the port's geometry ops (lie, camera, triangulation) with the
JAX package, on identical numpy inputs made from a seed, on the CPU.

Tolerance: both packages compute in f32 (JAX with x64 off, the port by
policy), so agreement is asked to a few f32 ulps of the quantity's scale,
stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangulation_in_deformable_scenes_torch.ops import camera as t_cam
from triangulation_in_deformable_scenes_torch.ops import lie as t_lie
from triangulation_in_deformable_scenes_torch.ops import triangulation as t_tri
from triangulation_in_deformable_scenes_tpu.ops import camera as j_cam
from triangulation_in_deformable_scenes_tpu.ops import lie as j_lie
from triangulation_in_deformable_scenes_tpu.ops import triangulation as j_tri

torch.set_num_threads(1)

KB8 = np.array([458.654, 457.296, 367.215, 248.375, -0.28, 0.07, 0.0002, 1.8e-5])


def T(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def J(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                               atol=atol, rtol=rtol)


# --------------------------------------------------------------------- lie

@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.5])
def test_exp_maps_match(scale):
    """so3_exp / se3_exp across the series branch (theta^2 < 1e-8) and the
    closed form; entries are O(1), so 2e-6 is a few f32 ulps for R. The
    translation's (theta - sin theta) / theta^3 coefficient cancels
    catastrophically in f32 near theta ~ 1e-3 in both packages (one ulp of a
    different sin moves it by ~1e-1 relative, times |W^2 v| ~ 1e-5), hence
    5e-5 for t."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 3)) * scale
    xi = np.concatenate([w, rng.normal(size=(16, 3))], axis=-1)
    close(t_lie.so3_exp(T(w)), j_lie.so3_exp(J(w)), atol=2e-6)
    close(t_lie.hat(T(w)), j_lie.hat(J(w)), atol=0)
    Rt, tt = t_lie.se3_exp(T(xi))
    Rj, tj = j_lie.se3_exp(J(xi))
    close(Rt, Rj, atol=2e-6)
    close(tt, tj, atol=5e-5)


def test_log_compose_inverse_apply_match():
    rng = np.random.default_rng(2)
    R = np.asarray(j_lie.so3_exp(J(rng.normal(size=(8, 3)))))
    t = rng.normal(size=(8, 3))
    p = rng.normal(size=(8, 3))
    close(t_lie.so3_log(T(R)), j_lie.so3_log(J(R)), atol=2e-5)
    for a, b in zip(t_lie.compose(T(R), T(t), T(R[::-1]), T(t[::-1])),
                    j_lie.compose(J(R), J(t), J(R[::-1]), J(t[::-1]))):
        close(a, b, atol=5e-6)
    for a, b in zip(t_lie.inverse(T(R), T(t)), j_lie.inverse(J(R), J(t))):
        close(a, b, atol=5e-6)
    close(t_lie.apply(T(R), T(t), T(p)), j_lie.apply(J(R), J(t), J(p)), atol=5e-6)


def test_look_at_and_kabsch_match():
    rng = np.random.default_rng(3)
    cam, target = np.array([0.14, 0.01, 0.06]), np.array([0.01, -0.02, 0.21])
    close(t_lie.look_at(T(cam), T(target)), j_lie.look_at(J(cam), J(target)), atol=2e-6)
    src = rng.normal(size=(30, 3)) * 0.05
    R_true = np.asarray(j_lie.so3_exp(J([0.2, -0.1, 0.3])))
    dst = src @ R_true.T + 0.01 * rng.normal(size=(30, 3))
    w = rng.uniform(0.5, 1.5, size=30)
    for a, b in zip(t_lie.kabsch(T(src), T(dst), T(w)), j_lie.kabsch(J(src), J(dst), J(w))):
        close(a, b, atol=1e-5)


def test_fit_rotation_det_flip_matches():
    """Half the matrices are improper (det < 0 before the fix): the flip of
    U's third column must agree, and every result is a proper rotation."""
    rng = np.random.default_rng(4)
    H = rng.normal(size=(64, 3, 3))
    H[::2, :, 0] *= -1.0
    Rt = t_lie.fit_rotation(T(H))
    close(Rt, j_lie.fit_rotation(J(H)), atol=1e-5)
    close(torch.linalg.det(Rt), np.ones(64), atol=1e-5)


def test_quat_to_matrix_matches():
    """Random and unnormalised quaternions, the identity and the zero
    quaternion (identity by the n > 0 guard): within 1e-6 of JAX (the same
    f32 products; XLA may fuse them), proper rotations."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(50, 4)) * rng.uniform(0.5, 2.0, size=(50, 1))
    q = np.concatenate([q, [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]]])
    Rt = t_lie.quat_to_matrix(T(q))
    close(Rt, j_lie.quat_to_matrix(J(q)), atol=1e-6)
    close(torch.linalg.det(Rt[:-1]), np.ones(51), atol=1e-5)
    close(Rt[-2], np.eye(3), atol=0)
    close(Rt[-1], np.eye(3), atol=0)


# ------------------------------------------------------------------ camera

def _points(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3)) * [0.3, 0.25, 0.1] + [0, 0, 0.5]


@pytest.mark.parametrize("kind", ["KB8", "PinHole"])
def test_project_unproject_match(kind):
    """Pixels to 1e-3 px (f32 ulp at ~500 px is 6e-5, and atan/poly order
    differs); Newton-unprojected unit rays to 1e-6."""
    p = _points()
    close(t_cam.project(kind, T(KB8), T(p)), j_cam.project(kind, J(KB8), J(p)), atol=1e-3)
    pix = np.asarray(j_cam.project(kind, J(KB8), J(p)))
    close(t_cam.unproject(kind, T(KB8), T(pix)), j_cam.unproject(kind, J(KB8), J(pix)), atol=2e-6)


@pytest.mark.parametrize("kind", ["KB8", "PinHole"])
def test_project_jac_matches_jax_and_jacfwd(kind):
    """Analytic Jacobian against the JAX package's and against
    ``torch.func.jacfwd`` of the port's own projection (rtol 2e-5 as the JAX
    package's test_project_jac_matches_jacfwd asks)."""
    p = _points(40)
    got = t_cam.project_jac(kind, T(KB8), T(p))
    close(got, j_cam.project_jac(kind, J(KB8), J(p)), rtol=2e-5, atol=1e-4)
    # Jacobian of the batched projection over the whole [N, 3] input, then its
    # per-point diagonal blocks [N, 2, 3].
    full = torch.func.jacfwd(lambda q: t_cam.project(kind, T(KB8), q))(T(p))
    idx = torch.arange(len(p))
    want = full[idx, :, idx, :]
    close(got, want, rtol=2e-5, atol=1e-4)


# ----------------------------------------------------------- triangulation

def _two_view(seed=0, n=40, noise=0.0):
    rng = np.random.default_rng(seed)
    pts1 = rng.normal(size=(n, 3)) * np.array([0.05, 0.04, 0.01]) + np.array([0.0, 0.0, 0.2])
    pts2 = pts1 + rng.normal(size=(n, 3)) * 0.004
    c1, c2 = np.array([-0.12, 0.02, 0.0]), np.array([0.12, 0.01, 0.0])

    def look(c, tg):
        return np.asarray(j_lie.look_at(J(c), J(tg)), dtype=np.float64)

    T1w = (look(c1, pts1.mean(0)), c1)
    T2w = (look(c2, pts2.mean(0)), c2)
    pc1 = pts1 @ T1w[0].T + T1w[1]
    pc2 = pts2 @ T2w[0].T + T2w[1]
    xn1 = pc1 / np.linalg.norm(pc1, axis=-1, keepdims=True) + noise * rng.normal(size=(n, 3))
    xn2 = pc2 / np.linalg.norm(pc2, axis=-1, keepdims=True) + noise * rng.normal(size=(n, 3))
    return xn1, xn2, T1w, T2w, pc1[:, 2], pc2[:, 2]


@pytest.mark.parametrize("method", ["Classic", "NRSLAM", "ORBSLAM", "DepthMeasurement"])
@pytest.mark.parametrize("location", ["inRays", "TwoPoints", "FarPoints"])
def test_triangulate_matches(method, location):
    """All 4 methods x 3 seed locations on noisy rays. Points are ~0.2 m from
    the cameras; Classic's middle singular vector is ill-conditioned (see
    tests/test_triangulation.py), so it gets 5e-4 m, the others 2e-6 m."""
    xn1, xn2, T1w, T2w, z1, z2 = _two_view(noise=2e-3)
    if method == "DepthMeasurement":
        xn1 = xn1 / xn1[:, 2:3] * z1[:, None]
        xn2 = xn2 / xn2[:, 2:3] * z2[:, None]
    got = t_tri.triangulate(T(xn1), T(xn2), (T(T1w[0]), T(T1w[1])), (T(T2w[0]), T(T2w[1])),
                            method=method, location=location)
    want = j_tri.triangulate(J(xn1), J(xn2), (J(T1w[0]), J(T1w[1])), (J(T2w[0]), J(T2w[1])),
                             method=method, location=location)
    atol = 5e-4 if method == "Classic" else 2e-6
    for a, b in zip(got, want):
        assert np.all(np.isfinite(np.asarray(a)))
        close(a, b, atol=atol)


@pytest.mark.parametrize("min_cos", [0.9998, 0.95, -1.0])
def test_valid_parallax_mask_matches(min_cos):
    """Same boolean mask, including points pushed behind camera 2."""
    xn1, xn2, T1w, T2w, _, _ = _two_view(seed=5, noise=1e-3)
    x1, x2 = j_tri.triangulate(J(xn1), J(xn2), (J(T1w[0]), J(T1w[1])), (J(T2w[0]), J(T2w[1])))
    x2 = np.asarray(x2).copy()
    x2[::7] = 2 * np.asarray(T2w[1]) - x2[::7] + np.array([0, 0, -1.0])
    got = t_tri.valid_parallax_mask(T(xn1), T(xn2), (T(T1w[0]), T(T1w[1])), (T(T2w[0]), T(T2w[1])),
                                    T(x1), T(x2), min_cos)
    want = j_tri.valid_parallax_mask(J(xn1), J(xn2), (J(T1w[0]), J(T1w[1])), (J(T2w[0]), J(T2w[1])),
                                     J(x1), J(x2), min_cos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
