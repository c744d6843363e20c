"""Map-quality metrics with reference parity.

Counterpart of ``triangulation_in_deformable_scenes_tpu/utils/metrics.py``:
``pixels_stand_dev`` (:47-69), ``sim_absolute_errors`` (:80-101),
``bilinear_interpolate`` (:104-122), ``real_absolute_errors`` (:125-188),
``relative_map_errors`` (:200-237) and ``mean_parallax_degrees`` (:240-250).
Projections run in f32 on the device of the tensors they are given, as the
JAX package runs them on its device; the reductions are numpy f64 on the
host. See that module's docstring for the deliberate deviations from the
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import mesh as mesh_ops
from ..precision import FP


@dataclasses.dataclass
class PixelsError:
    avgc1: float = 0.0
    avgc2: float = 0.0
    avg: float = 0.0
    desvc1: float = 0.0
    desvc2: float = 0.0
    desv: float = 0.0


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=FP)
    return torch.as_tensor(np.asarray(x), dtype=FP, device=device)


def _abs_pixel_errors(cam_kind, cam_params, R, t, p, kp, device):
    pc = lie.apply(_f32(R, device), _f32(t, device), _f32(p, device))
    proj = tracing.read(cam_ops.project(cam_kind, _f32(cam_params, device), pc))
    return np.abs(np.asarray(kp) - proj)


def _np(x):
    return tracing.read(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def pixels_stand_dev(cam_kind, cam_params, T1w, T2w, p1, p2, kp1, kp2, valid, device="cuda") -> PixelsError:
    """Parity with ``calculatePixelsStandDev`` (``Geometry.cc:370-498``)."""
    valid = np.asarray(_np(valid), dtype=bool)
    e1 = _abs_pixel_errors(cam_kind, cam_params, T1w[0], T1w[1], _np(p1)[valid], np.asarray(kp1)[valid], device)
    e2 = _abs_pixel_errors(cam_kind, cam_params, T2w[0], T2w[1], _np(p2)[valid], np.asarray(kp2)[valid], device)
    n = max(len(e1), 1)

    mean1 = e1.mean(axis=0) if len(e1) else np.zeros(2)
    mean2 = e2.mean(axis=0) if len(e2) else np.zeros(2)
    mean12 = (e1 + e2).sum(axis=0) / (2.0 * n)

    rms1 = np.sqrt((e1**2).mean(axis=0)) if len(e1) else np.zeros(2)
    rms2 = np.sqrt((e2**2).mean(axis=0)) if len(e2) else np.zeros(2)

    return PixelsError(
        avgc1=float(mean1.mean()),
        avgc2=float(mean2.mean()),
        avg=float(mean12.mean()),
        desvc1=float(rms1.mean()),
        desvc2=float(rms2.mean()),
        desv=float((rms1.mean() + rms2.mean()) / 2.0),
    )


@dataclasses.dataclass
class AbsoluteErrors:
    av_movement: float = 0.0
    av_error: float = 0.0
    rmse: float = 0.0
    av_up_to_scale: float | None = None


def sim_absolute_errors(p1, p2, valid, gt_index, original, moved) -> AbsoluteErrors:
    """Parity with ``measureSimAbsoluteMapErrors`` (``Measurements.cc:8-98``)."""
    valid = np.asarray(_np(valid), dtype=bool)
    idx = np.asarray(gt_index)[valid]
    o = np.asarray(original)[idx]
    m = np.asarray(moved)[idx]
    e1 = _np(p1)[valid] - o
    e2 = _np(p2)[valid] - m
    mv = np.linalg.norm(o - m, axis=-1)

    n_pairs = max(len(o), 1)
    n_points = 2 * n_pairs
    total_err = np.linalg.norm(e1, axis=-1).sum() + np.linalg.norm(e2, axis=-1).sum()
    total_sq = (e1**2).sum() + (e2**2).sum()
    return AbsoluteErrors(
        av_movement=float(mv.sum() / n_pairs),
        av_error=float(total_err / n_points),
        rmse=float(np.sqrt(total_sq / n_points)),
    )


def bilinear_interpolate(mat: np.ndarray, x, y) -> np.ndarray:
    """Image bilinear lookup, parity with ``Interpolate`` (Geometry.cc:607-620)."""
    mat = np.asarray(mat, dtype=np.float64)
    x = np.asarray(_np(x), dtype=np.float64)
    y = np.asarray(_np(y), dtype=np.float64)
    x0 = np.clip(np.floor(x).astype(int), 0, mat.shape[1] - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, mat.shape[0] - 2)
    fx = x - x0
    fy = y - y0
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = 1 - w00 - w01 - w10
    return (
        mat[y0, x0] * w00
        + mat[y0, x0 + 1] * w10
        + mat[y0 + 1, x0] * w01
        + mat[y0 + 1, x0 + 1] * w11
    )


def real_absolute_errors(ph_params, T1w, T2w, p1, p2, kp1, kp2, d1, d2, valid) -> AbsoluteErrors:
    """Parity with ``measureRealAbsoluteMapErrors`` (``Measurements.cc:101-348``).

    Ground truth back-projects the measured depths through the PINHOLE model
    (X = unproject(kp)/z * d, lifted to world by the inverse pose); the
    up-to-scale variant first divides the depths by the mean realised scale
    d / z_map. Host numpy, as in JAX."""
    valid = np.asarray(_np(valid), dtype=bool)
    kp1v, kp2v = _np(kp1)[valid], _np(kp2)[valid]
    p1v, p2v = _np(p1)[valid], _np(p2)[valid]
    d1v, d2v = _np(d1)[valid], _np(d2)[valid]

    fx, fy, cx, cy = np.asarray(ph_params)[:4]

    def backproject(kp, d):
        rx = (kp[:, 0] - cx) / fx
        ry = (kp[:, 1] - cy) / fy
        return np.stack([rx * d, ry * d, d], axis=-1)

    def to_world(Xc, T):
        R, t = _np(T[0]), _np(T[1])
        return (Xc - t) @ R  # R^T (Xc - t)

    gt1 = to_world(backproject(kp1v, d1v), T1w)
    gt2 = to_world(backproject(kp2v, d2v), T2w)

    z1 = (p1v @ _np(T1w[0]).T + _np(T1w[1]))[:, 2]
    z2 = (p2v @ _np(T2w[0]).T + _np(T2w[1]))[:, 2]
    scale1 = float((d1v / z1).mean())
    scale2 = float((d2v / z2).mean())

    e1 = p1v - gt1
    e2 = p2v - gt2
    mv = np.linalg.norm(gt1 - gt2, axis=-1)
    n_pairs = max(len(gt1), 1)
    n_points = 2 * n_pairs

    gt1s = to_world(backproject(kp1v, d1v / scale1), T1w)
    gt2s = to_world(backproject(kp2v, d2v / scale2), T2w)
    up_err = (
        np.linalg.norm(p1v - gt1s, axis=-1).sum() + np.linalg.norm(p2v - gt2s, axis=-1).sum()
    ) / n_points

    return AbsoluteErrors(
        av_movement=float(mv.sum() / n_pairs),
        av_error=float(
            (np.linalg.norm(e1, axis=-1).sum() + np.linalg.norm(e2, axis=-1).sum()) / n_points
        ),
        rmse=float(np.sqrt(((e1**2).sum() + (e2**2).sum()) / n_points)),
        av_up_to_scale=float(up_err),
    )


@dataclasses.dataclass
class RelativeErrors:
    rel_error: float = 0.0
    depth_error: float = 0.0
    global_t_error: float = 0.0
    Rg: np.ndarray = None
    tg: np.ndarray = None


def relative_map_errors(T1w, T2w, p1, p2, s1, s2, d1, d2, valid, Rg, tg, device="cuda") -> RelativeErrors:
    """Parity with ``measureRelativeMapErrors`` (``Measurements.cc:350-518``):
    a fresh Delaunay mesh on the current keyframe-1 cloud."""
    valid = np.asarray(_np(valid), dtype=bool)
    p1v = _np(p1)[valid]
    p2v = _np(p2)[valid]
    ctx = mesh_ops.build_mesh_context(p1v)

    j_safe = np.maximum(ctx.nbr, 0)
    mask = ctx.nbr_mask
    diff = (p2v[:, None, :] - p2v[j_safe]) - (p1v[:, None, :] - p1v[j_safe])
    rel = np.where(mask, (diff**2).sum(-1), 0.0)
    Rg_np, tg_np = _np(Rg), _np(tg)
    g_i = p2v @ Rg_np.T - tg_np - p1v
    g_j = p2v[j_safe] @ Rg_np.T - tg_np - p1v[j_safe]
    gd = g_i[:, None, :] + g_j
    glob = np.where(mask, (gd**2).sum(-1), 0.0)

    def z_of(T, p):
        return tracing.read(lie.apply(_f32(T[0], device), _f32(T[1], device), _f32(p, device)))[:, 2]

    z1 = z_of(T1w, p1v)
    z2 = z_of(T2w, p2v)
    d1v = np.asarray(d1)[valid]
    d2v = np.asarray(d2)[valid]
    depth_err = float(((d1v - z1 * s1) ** 2).sum() + ((d2v - z2 * s2) ** 2).sum())

    return RelativeErrors(
        rel_error=float(rel.sum() / ctx.surface_area),
        depth_error=depth_err,
        global_t_error=float(glob.sum() / ctx.surface_area),
        Rg=Rg_np,
        tg=tg_np,
    )


def mean_parallax_degrees(xn1, xn2, T1w, T2w, valid) -> float:
    """Mean angle between the two viewing rays over valid matches, degrees."""
    valid = np.asarray(_np(valid), dtype=bool)
    R1i = _np(T1w[0]).T
    R2i = _np(T2w[0]).T
    r1 = _np(xn1)[valid] @ R1i.T
    r2 = _np(xn2)[valid] @ R2i.T
    r1 /= np.linalg.norm(r1, axis=-1, keepdims=True)
    r2 /= np.linalg.norm(r2, axis=-1, keepdims=True)
    cosp = np.clip((r1 * r2).sum(-1), -1.0, 1.0)
    return float(np.degrees(np.arccos(cosp)).mean())
