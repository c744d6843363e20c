"""Camera, rigid-motion, triangulation and ARAP-rotation arithmetic of the
plain reference.

A frozen plain-PyTorch statement of the two-view deformable refinement's
geometry: the Kannala-Brandt (KB8) camera, SO(3)/SE(3) maps, the
back-projection-midpoint triangulation with its parallax gate, and the
per-vertex best-fit rotations of the as-rigid-as-possible (ARAP) energy.
It imports nothing of the program under test; the benchmark holds the
program's outputs against what these functions give on the same raw inputs.
"""

from __future__ import annotations

import torch

KB8_NEWTON_ITERS = 10
_EPS = 1e-12


# --- KB8 camera: parameters [fx, fy, cx, cy, k0..k3] ------------------------


def project(params, p3d):
    """Camera-frame points [..., 3] -> pixels [..., 2]."""
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


def unproject(params, pix):
    """Pixels [..., 2] -> unit rays [..., 3], Newton inversion of the radial
    polynomial."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (pix[..., 0] - cx) / fx
    my = (pix[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    theta = theta_d
    for _ in range(KB8_NEWTON_ITERS):
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


def project_jac(params, p3d):
    """d(projection)/d(camera point), [..., 2, 3]."""
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


# --- SO(3) / SE(3); the se(3) tangent is (omega, upsilon) -------------------


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w):
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
    """Rodrigues; the coefficients stay at least 1-d so that forward-mode AD
    keeps float32 tangents."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    use_series = theta2 < 1e-8
    a = torch.where(use_series, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(use_series, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    return _eye_like(W) + a[..., None] * W + b[..., None] * (W @ W)


def se3_exp(xi):
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
    return R, torch.einsum("...ij,...j->...i", V, v)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): b first, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def inverse(R, t):
    Rt = torch.swapaxes(R, -1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def apply(R, t, p):
    return torch.einsum("...ij,...j->...i", R, p) + t


def look_at(camera_pos, target_pos):
    """World-to-camera rotation with columns (right, up, forward)."""
    up = torch.tensor([0.0, 1.0, 0.0], dtype=camera_pos.dtype, device=camera_pos.device)
    forward = target_pos - camera_pos
    forward = forward / torch.linalg.norm(forward)
    right = torch.linalg.cross(up, forward)
    right = right / torch.linalg.norm(right)
    up2 = torch.linalg.cross(forward, right)
    up2 = up2 / torch.linalg.norm(up2)
    return torch.stack([right, up2, forward], dim=-1)


def fit_rotation(H):
    """Closest rotation to H [..., 3, 3] by SVD, reflection removed."""
    U, _, Vt = torch.linalg.svd(H)
    V = torch.swapaxes(Vt, -1, -2)
    R = V @ torch.swapaxes(U, -1, -2)
    det = torch.linalg.det(R)
    one = torch.ones_like(det)
    flip = torch.stack([one, one, torch.where(det < 0, -one, one)], dim=-1)
    U_fix = U * flip[..., None, :]
    return V @ torch.swapaxes(U_fix, -1, -2)


def kabsch(p_src, p_dst, weights):
    """Weighted best-fit rotation; t = R c_dst - c_src."""
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    c_src = torch.sum(weights[..., None] * p_src, dim=-2) / wsum
    c_dst = torch.sum(weights[..., None] * p_dst, dim=-2) / wsum
    a = p_src - c_src[..., None, :]
    b = p_dst - c_dst[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", weights, a, b)
    R = fit_rotation(H)
    return R, torch.einsum("...ij,...j->...i", R, c_dst) - c_src


# --- Dual-point triangulation (depth measurement, seeds in the rays) --------


def triangulate_depth_in_rays(xn1, xn2, T1w, T2w):
    """Metric rays (ray * depth) of both cameras -> (x3d at keyframe 1,
    x3d at keyframe 2) in the world: each camera's own back-projection."""
    R1i, t1i = inverse(*T1w)
    R21, t21 = compose(T2w[0], T2w[1], R1i, t1i)
    point0 = apply(R21, t21, xn1)
    R2i, t2i = inverse(*T2w)
    return apply(R2i, t2i, point0), apply(R2i, t2i, xn2)


def valid_parallax_mask(xn1, xn2, T1w, T2w, x1, x2, min_cos):
    """Positive depth in each camera and cos(parallax) <= min_cos."""
    z1 = apply(*T1w, x1)[..., 2]
    z2 = apply(*T2w, x2)[..., 2]
    R1i, _ = inverse(*T1w)
    R2i, _ = inverse(*T2w)
    ray1 = torch.einsum("ij,nj->ni", R1i, xn1)
    ray2 = torch.einsum("ij,nj->ni", R2i, xn2)
    cosp = torch.sum(ray1 * ray2, dim=-1) / (torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1))
    return (z1 >= 0.0) & (z2 >= 0.0) & (cosp <= min_cos)


# --- ARAP -------------------------------------------------------------------


def compute_rotations(p1, p2, nbr, nbr_mask, weights):
    """Best-fit rotation of each vertex's weighted p1 edge fan onto p2;
    identity where a vertex has no neighbour."""
    j = torch.clamp(nbr, min=0)
    e1 = p1[:, None, :] - p1[j]
    e2 = p2[:, None, :] - p2[j]
    w = torch.where(nbr_mask, weights, torch.zeros_like(weights))
    S = torch.einsum("nk,nki,nkj->nij", w, e1, e2)
    R = fit_rotation(S)
    has_nbr = torch.any(nbr_mask, dim=-1)
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device).expand(R.shape)
    return torch.where(has_nbr[:, None, None], R, eye)


def arap_edge_energy(p1, p2, R, nbr, nbr_mask, weights, area, Rg, tg):
    """Energy of every directed mesh edge [N, K] (zeros on padding): the two
    rotated-edge residuals over the surface area, plus the global-alignment
    term of both ends."""
    j = torch.clamp(nbr, min=0)
    p1j, p2j, Rj = p1[j], p2[j], R[j]
    d1i = p1[:, None, :] - p1j
    d2i = p2[:, None, :] - p2j
    Ri_d1i = torch.einsum("nab,nkb->nka", R, d1i)
    Rj_d1j = torch.einsum("nkab,nkb->nka", Rj, -d1i)
    first = (d2i - Ri_d1i) / area
    second = (-d2i - Rj_d1j) / area
    g_i = torch.einsum("ab,nb->na", Rg, p2) - tg - p1
    g_j = torch.einsum("ab,nkb->nka", Rg, p2j) - tg - p1j
    diff_global = g_i[:, None, :] + g_j
    energy_global = torch.sum(diff_global * diff_global, dim=-1)
    energy = (
        weights * (torch.sum(first * first, dim=-1) + torch.sum(second * second, dim=-1))
        + energy_global
    )
    return torch.where(nbr_mask, energy, torch.zeros_like(energy))
