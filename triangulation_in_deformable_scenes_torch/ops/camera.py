"""Batched camera models: Kannala-Brandt fisheye (KB8) and pinhole.

Counterpart of ``triangulation_in_deformable_scenes_tpu/ops/camera.py:24-195``.
Parameters layout: [fx, fy, cx, cy, k0..k3]; pinhole uses the first four.
"""

from __future__ import annotations

import torch

_KB8_NEWTON_ITERS = 10  # reference uses 10 Newton steps (KannalaBrandt8.cc:64)


def kb8_project(params, p3d):
    """KB8 projection of camera-frame points p3d[..., 3] -> pixels [..., 2]
    (``camera.py:24-42``)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    pos = r > 0
    safe_r = torch.where(pos, r, torch.ones_like(r))
    zero = torch.zeros_like(r)
    u = fx * d * torch.where(pos, x / safe_r, zero) + cx
    v = fy * d * torch.where(pos, y / safe_r, zero) + cy
    return torch.stack([u, v], dim=-1)


def kb8_unproject(params, pix):
    """KB8 unprojection to unit rays [..., 3] by Newton inversion of the
    radial polynomial (``camera.py:45-71``)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (pix[..., 0] - cx) / fx
    my = (pix[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    theta = theta_d
    for _ in range(_KB8_NEWTON_ITERS):
        t2 = theta * theta
        t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
        f = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8) - theta_d
        fp = 1 + 3 * k[0] * t2 + 5 * k[1] * t4 + 7 * k[2] * t6 + 9 * k[3] * t8
        theta = theta - f / fp
    big = theta_d > 1e-8
    safe_td = torch.where(big, theta_d, torch.ones_like(theta_d))
    sin_t = torch.sin(theta)
    zero = torch.zeros_like(theta)
    rx = torch.where(big, sin_t * mx / safe_td, zero)
    ry = torch.where(big, sin_t * my / safe_td, zero)
    rz = torch.where(big, torch.cos(theta), torch.ones_like(theta))
    return torch.stack([rx, ry, rz], dim=-1)


def pinhole_project(params, p3d):
    """``PinHole::project``: u = fx x/z + cx."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = p3d[..., 2]
    u = fx * p3d[..., 0] / z + cx
    v = fy * p3d[..., 1] / z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params, pix):
    """``PinHole::unproject``: ray ((u-cx)/fx, (v-cy)/fy, 1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    rx = (pix[..., 0] - cx) / fx
    ry = (pix[..., 1] - cy) / fy
    return torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)


def kb8_project_jac(params, p3d):
    """Analytic d(projection)/d(camera point): [..., 2, 3]
    (``camera.py:91-132``)."""
    fx, fy = params[0], params[1]
    k = params[4:8]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    R2 = r2 + z * z
    theta = torch.atan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    dp = 1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (7.0 * k[2] + t2 * 9.0 * k[3])))
    pos = r > 0
    safe_r = torch.where(pos, r, torch.ones_like(r))
    safe_r3 = safe_r * safe_r * safe_r
    zero = torch.zeros_like(r)
    cx_ = torch.where(pos, x / safe_r, zero)
    cy_ = torch.where(pos, y / safe_r, zero)
    th_x = torch.where(pos, z * x / (safe_r * R2), zero)
    th_y = torch.where(pos, z * y / (safe_r * R2), zero)
    th_z = -r / R2
    g_xx = torch.where(pos, y * y / safe_r3, zero)
    g_xy = torch.where(pos, -x * y / safe_r3, zero)
    g_yy = torch.where(pos, x * x / safe_r3, zero)
    du_dx = fx * (dp * th_x * cx_ + d * g_xx)
    du_dy = fx * (dp * th_y * cx_ + d * g_xy)
    du_dz = fx * (dp * th_z * cx_)
    dv_dx = fy * (dp * th_x * cy_ + d * g_xy)
    dv_dy = fy * (dp * th_y * cy_ + d * g_yy)
    dv_dz = fy * (dp * th_z * cy_)
    row_u = torch.stack([du_dx, du_dy, du_dz], dim=-1)
    row_v = torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def pinhole_project_jac(params, p3d):
    """Analytic pinhole projection Jacobian (``camera.py:135-143``)."""
    fx, fy = params[0], params[1]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    inv_z = 1.0 / z
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], dim=-1)
    row_v = torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


KB8 = "KB8"
PINHOLE = "PinHole"

_PROJECT = {KB8: kb8_project, PINHOLE: pinhole_project}
_UNPROJECT = {KB8: kb8_unproject, PINHOLE: pinhole_unproject}
_PROJECT_JAC = {KB8: kb8_project_jac, PINHOLE: pinhole_project_jac}


def project(kind, params, p3d):
    return _PROJECT[kind](params, p3d)


def unproject(kind, params, pix):
    return _UNPROJECT[kind](params, pix)


def project_jac(kind, params, p3d):
    """Analytic d(project)/d(camera point), [..., 2, 3]."""
    return _PROJECT_JAC[kind](params, p3d)


def undistort_points(params, distortion, pix, iters: int = 5):
    """Radial-tangential keypoint undistortion, ``cv::undistortPoints``
    semantics with P = K (``Frame::undistortKeys``, Frame.cc:252-277;
    ``camera.py:172-195``). ``distortion`` = (k1, k2, p1, p2[, k3]); five
    unrolled rounds of the fixed-point compensation iteration, as OpenCV's
    default criteria run. Returns undistorted pixels, the shape of ``pix``."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, p1, p2 = distortion[0], distortion[1], distortion[2], distortion[3]
    k3 = distortion[4] if len(distortion) > 4 else 0.0

    x0 = (pix[..., 0] - cx) / fx
    y0 = (pix[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)
