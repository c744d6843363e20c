"""Traffic generation: the sweep's conditions drawn from a seed.

A traffic mix (``traffic/<mix>.json``) lists its conditions: camera depth
(and with it the second camera's pose), shape (Planar, Gradual) and
experiment type (gaussian and rigid movement in mm). Condition k of a run is
entry k mod the list's length, for every seed alike, so that the seed does
not change the kind of work; the seed draws its ground-truth points, from
``numpy.random.default_rng([seed, k])``, and its observation noise seed,
``seed * 1000 + k``. The points follow
the reference's ``Data/Scripts/synthetic/create_data.py``: a gaussian cloud
rotated into the camera's frustum, moved by a rigid offset along y that is
constant (Planar) or grows linearly with x (Gradual), plus isotropic
gaussian movement.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class Condition(NamedTuple):
    index: int
    label: str
    c2_pose: tuple
    orig: np.ndarray  # [N, 3] ground truth at keyframe 1
    moved: np.ndarray  # [N, 3] ground truth at keyframe 2
    noise_seed: int


def _rotation_xyz(ax, ay, az):
    ax, ay, az = np.deg2rad([ax, ay, az])
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def points(rng, num_points: int, rigid: float, gaussian: float, z_mean: float, shape: str, fx: dict):
    """(original, moved) [N, 3] in metres; ``fx`` is the configuration's
    ``fixture`` block."""
    orig = np.zeros((num_points, 3))
    orig[:, 0] = rng.normal(0.0, fx["x_std"], num_points)
    orig[:, 1] = rng.normal(0.0, fx["y_std"], num_points)
    orig[:, 2] = rng.normal(0.0, fx["z_std"], num_points)
    moved = orig.copy()
    axis = {"x": 0, "y": 1, "z": 2}[fx["grad_direction"]]
    if shape == "Gradual":
        moved[:, axis] += rigid * (1.0 + fx["grad_intensity"] * moved[:, 0])
    else:
        moved[:, axis] += rigid
    moved += rng.normal(scale=max(gaussian, 1e-300), size=moved.shape)
    R = _rotation_xyz(fx["angle_x"], fx["angle_y"], fx["angle_z"])
    mean = np.array([0.0, 0.0, z_mean])
    return orig @ R.T + mean, moved @ R.T + mean


def conditions(cfg: dict, traffic: dict, seed: int, count: int, first: int = 0) -> list:
    """Conditions ``first`` .. ``first + count - 1`` of the run with ``seed``."""
    listed = traffic["conditions"]
    out = []
    for k in range(first, first + count):
        depth, shape, etype = listed[k % len(listed)]
        mv = traffic["movement_mm_by_type"][str(etype)]
        orig, moved = points(np.random.default_rng([seed, k]), cfg["num_points"], mv["rigid"] / 1000.0,
                             mv["gaussian"] / 1000.0, depth / 100.0, shape, cfg["fixture"])
        out.append(Condition(
            index=k, label=f"{depth}cm-{shape}-type{etype}",
            c2_pose=tuple(traffic["camera2_pose_by_depth_cm"][str(depth)]),
            orig=orig, moved=moved, noise_seed=seed * 1000 + k,
        ))
    return out


def write_fixture(directory: str, cond: Condition):
    """The condition's ground truth as the reference's whitespace-separated
    point files; returns (original, moved) paths."""
    of = os.path.join(directory, f"original_points_{cond.index}.csv")
    mf = os.path.join(directory, f"moved_points_{cond.index}.csv")
    np.savetxt(of, cond.orig, delimiter=" ")
    np.savetxt(mf, cond.moved, delimiter=" ")
    return of, mf
