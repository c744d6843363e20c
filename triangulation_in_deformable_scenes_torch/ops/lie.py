"""SO(3)/SE(3) operations on batched tensors.

Counterpart of ``triangulation_in_deformable_scenes_tpu/ops/lie.py:21-174``.
A rigid transform is a pair ``(R[..., 3, 3], t[..., 3])``; the se(3) tangent
is ordered (omega, upsilon), rotation first, as g2o's ``SE3Quat::exp``.
Every function is made of plain tensor ops, so ``torch.func.jacfwd`` passes
through it (the LM assemblies differentiate ``se3_exp``). The exp maps keep
their per-rotation coefficients at least 1-d: in forward-mode AD a python
float combined with a 0-d dual tensor can give a float64 tangent, which then
fails to mix with the float32 values.
"""

from __future__ import annotations

import torch

# Numerically-safe threshold for small-angle series expansions.
_EPS = 1e-12


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w):
    """so(3) hat operator: w[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Rodrigues formula, w[..., 3] -> R[..., 3, 3]; stable at theta ~ 0
    (``lie.py:35-45``)."""
    # keepdim: the coefficients stay at least 1-d (see the module docstring).
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    use_series = theta2 < 1e-8
    a = torch.where(use_series, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_series, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    return _eye_like(W) + a[..., None] * W + b[..., None] * (W @ W)


def so3_log(R):
    """R[..., 3, 3] -> w[..., 3] (``lie.py:48-63``)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-6
    safe = torch.where(small, torch.ones_like(theta), theta)
    scale = torch.where(small, 0.5 + theta**2 / 12.0, theta / (2.0 * torch.sin(safe)))
    return scale[..., None] * vee


def se3_exp(xi):
    """se(3) exp with tangent xi = (omega[3], upsilon[3]) -> (R, t)
    (``lie.py:66-86``)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    use_series = theta2 < 1e-8
    R = so3_exp(w)
    W = hat(w)
    b = torch.where(use_series, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(
        use_series,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta + _EPS),
    )
    V = _eye_like(R) + b[..., None] * W + c[..., None] * (W @ W)
    t = torch.einsum("...ij,...j->...i", V, v)
    return R, t


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): apply b first, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def inverse(R, t):
    Rt = torch.swapaxes(R, -1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def apply(R, t, p):
    """Transform points p[..., 3]."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def look_at(camera_pos, target_pos, up=None):
    """Rotation whose columns are (right, up, forward) world-frame axes
    (``lie.py:104-121``; used directly as the world-to-camera rotation)."""
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], dtype=camera_pos.dtype, device=camera_pos.device)
    forward = target_pos - camera_pos
    forward = forward / torch.linalg.norm(forward)
    right = torch.linalg.cross(up, forward)
    right = right / torch.linalg.norm(right)
    up2 = torch.linalg.cross(forward, right)
    up2 = up2 / torch.linalg.norm(up2)
    return torch.stack([right, up2, forward], dim=-1)


def kabsch(p_src, p_dst, weights=None):
    """Best-fit rotation/translation between point sets (``lie.py:124-141``),
    with the reference's translation convention t = R.c_dst - c_src."""
    if weights is None:
        weights = torch.ones(p_src.shape[:-1], dtype=p_src.dtype, device=p_src.device)
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    c_src = torch.sum(weights[..., None] * p_src, dim=-2) / wsum
    c_dst = torch.sum(weights[..., None] * p_dst, dim=-2) / wsum
    a = p_src - c_src[..., None, :]
    b = p_dst - c_dst[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", weights, a, b)
    R = fit_rotation(H)
    t = torch.einsum("...ij,...j->...i", R, c_dst) - c_src
    return R, t


def fit_rotation(H):
    """Closest rotation of H[..., 3, 3] via SVD: R = V U^T, with U's third
    column flipped where det(V U^T) < 0 (``lie.py:144-156``).

    R is invariant to the joint sign of each singular-vector pair, so the
    SVD's sign convention does not reach the result.
    """
    U, _, Vt = torch.linalg.svd(H)
    V = torch.swapaxes(Vt, -1, -2)
    R = V @ torch.swapaxes(U, -1, -2)
    det = torch.linalg.det(R)
    one = torch.ones_like(det)
    flip = torch.stack([one, one, torch.where(det < 0, -one, one)], dim=-1)
    U_fix = U * flip[..., None, :]
    return V @ torch.swapaxes(U_fix, -1, -2)


def quat_to_matrix(q):
    """Quaternion (x, y, z, w) [..., 4] -> rotation matrix [..., 3, 3]
    (``lie.py:159-174``); a zero quaternion gives the identity."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )
