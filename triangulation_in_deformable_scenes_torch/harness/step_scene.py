"""A rendered two-depth "step" scene for the image-sequence path, numpy only.

The scene of the JAX package's sequence test (``tests/test_sequence_e2e.py:25-48,
181-215``): a textured plane at z = 0.9 m fills the left half of each frame
and one at z = 1.3 m the right half, seen through a KB8 camera with zero
distortion (equidistant) that translates between the two frames. Two
changes against that test: the texture blur is a separable [1, 2, 1] / 4
in numpy instead of cv2's 3x3 Gaussian, and the depth is quantised to
uint16 centimetres and back to float32, as a Drunkard depth PNG reaches the
pipeline (``datasets/loaders.py``). Everything comes from a seed, so the
port and the JAX package see identical frames.

Two sizes:

- ``SMALL`` (320 x 320, fx 190.68, 256^2 texture with 160 rectangles, seed 1,
  baseline (0.12, 0.02, 0) m): the CPU tests' scene, the test's own.
- ``FULL`` (1024 x 1024, fx 610.18 = Drunkard's ``1024`` intrinsics,
  ``harness/real_sweep.py``; 512^2 texture with 640 rectangles, the same
  density; baseline (0.08, 0.01, 0) m): the full-width scene of
  ``chip_smoke.py``. Its disparities stay under ~55 px, inside the 75 px
  window of the pair preset ``1024_00000_1229-1236``.

``scene_config`` gives each size its pipeline ``Config``. ``StepSceneLoader``
hands the frames to ``SequencePipeline.run`` the way a
dataset loader does, without files: ``frames()`` yields (idx, rgb uint8
[H, W, 3], depth float32 [H, W] in cm, (R_wc, t_wc), timestamp).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import Config


@dataclasses.dataclass(frozen=True)
class StepScene:
    size: int  # frame width = height (px)
    fx: float  # focal length (px); cx = cy = size / 2
    tex_size: int
    n_rects: int
    seed: int
    baseline: tuple  # camera-2 position (m); camera 1 at the origin


SMALL = StepScene(size=320, fx=190.68059285, tex_size=256, n_rects=160, seed=1, baseline=(0.12, 0.02, 0.0))
FULL = StepScene(size=1024, fx=610.17789714, tex_size=512, n_rects=640, seed=1, baseline=(0.08, 0.01, 0.0))


def make_texture(rng, size: int, n_rects: int) -> np.ndarray:
    """Random rectangles over grey 128 (smooth regions with sharp corners),
    blurred by a separable [1, 2, 1] / 4 with a reflect border; uint8."""
    tex = np.full((size, size), 128, dtype=np.uint8)
    for _ in range(n_rects):
        y, x = rng.integers(0, size - 20, size=2)
        hh, ww = rng.integers(6, 28, size=2)
        tex[y : y + hh, x : x + ww] = rng.integers(30, 230)
    t = np.pad(tex.astype(np.float64), 1, mode="reflect")
    t = 0.25 * t[:-2] + 0.5 * t[1:-1] + 0.25 * t[2:]
    t = 0.25 * t[:, :-2] + 0.5 * t[:, 1:-1] + 0.25 * t[:, 2:]
    return np.round(t).astype(np.uint8)


def render_plane(R_wc, t_wc, texture, fx: float, size: int, tex_scale=200.0, plane_z=1.0):
    """Render the textured z = plane_z plane through the KB8 (d = 0) camera at
    (R_wc, t_wc); returns (gray uint8 [H, W], z-depth float64 [H, W] in m)."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    mx = (xs - size / 2) / fx
    my = (ys - size / 2) / fx
    theta = np.sqrt(mx**2 + my**2)
    r = np.tan(theta)  # equidistant inverse
    safe = np.where(theta > 1e-9, theta, 1.0)
    dx = np.where(theta > 1e-9, mx / safe * r, 0.0)
    dy = np.where(theta > 1e-9, my / safe * r, 0.0)
    dirs_c = np.stack([dx, dy, np.ones_like(dx)], -1)
    dirs_w = dirs_c @ np.asarray(R_wc).T
    origin = np.asarray(t_wc)
    tz = (plane_z - origin[2]) / dirs_w[..., 2]
    pts = origin + tz[..., None] * dirs_w
    u = (pts[..., 0] * tex_scale) % texture.shape[1]
    v = (pts[..., 1] * tex_scale) % texture.shape[0]
    im = texture[v.astype(int) % texture.shape[0], u.astype(int) % texture.shape[1]]
    return im, tz * dirs_c[..., 2]


def step_frames(scene: StepScene):
    """The scene's two frames: [(rgb uint8 [H, W, 3], depth float32 [H, W]
    in cm, (R_wc, t_wc))], camera 1 at the origin, camera 2 at the
    baseline, both looking down +z."""
    rng = np.random.default_rng(scene.seed)
    texture = make_texture(rng, scene.tex_size, scene.n_rects)
    half = scene.size // 2
    out = []
    for t in (np.zeros(3), np.asarray(scene.baseline, dtype=np.float64)):
        R = np.eye(3)
        im_a, depth_a = render_plane(R, t, texture, scene.fx, scene.size, plane_z=0.9)
        im_b, depth_b = render_plane(R, t, texture, scene.fx, scene.size, plane_z=1.3, tex_scale=140.0)
        im = np.concatenate([im_a[:, :half], im_b[:, half:]], axis=1)
        depth = np.concatenate([depth_a[:, :half], depth_b[:, half:]], axis=1)
        rgb = np.stack([im, im, im], -1).astype(np.uint8)
        d16 = np.clip(depth * 100.0, 0, 65535).astype(np.uint16)
        out.append((rgb, d16.astype(np.float32), (R, t)))
    return out


class StepSceneLoader:
    """Frames from memory in the loaders' ``frames()`` form."""

    def __init__(self, frames):
        self._frames = list(frames)

    def __len__(self):
        return len(self._frames)

    def frames(self, start=0, end=None, step=1):
        end = len(self) - 1 if end is None else min(end, len(self) - 1)
        for i in range(start, end + 1, step):
            rgb, depth, pose = self._frames[i]
            yield i, rgb, depth, pose, float(i)


def scene_config(scene: StepScene, n_optimizations=5, nlopt_evals=8, n_opt_iterations=25) -> Config:
    """The pipeline settings of a scene, with the refinement budget given.

    Both sizes take the JAX sequence test's matching-independent settings
    (``tests/test_sequence_e2e.py:82-118``: 20 matches at least, no epipolar
    checks, NRSLAM in-rays triangulation, ARAP weights searched over
    [1e-5, 1e7] by twoOptimizations + nlopt, 300 mm depth weight). ``SMALL``
    keeps that test's extractor and gates (600 features in 4 scales, Hamming
    40, window 60 px, depth limit 3.5 m, parallax 0.6 deg). ``FULL`` takes
    Drunkard's ``1024`` intrinsics and the preset of pair
    ``1024_00000_1229-1236`` (Hamming 30, window 75 px, depth limit 2.5 m,
    parallax 1.9 deg; ``harness/real_sweep.py``) and the JAX package's
    front-end bench extractor (1000 features, 8 scales, factor 1.2;
    ``bench.py:823``)."""
    base = Config(
        fx=scene.fx,
        fy=scene.fx,
        cx=scene.size / 2,
        cy=scene.size / 2,
        im_cols=scene.size,
        im_rows=scene.size,
        n_features=600,
        n_scales=4,
        scale_factor=1.2,
        matching_init_th=40,
        matching_init_radius=60.0,
        min_cos=0.6,
        min_matches=20,
        depth_limit=3.5,
        checks=False,
        triangulation_method="NRSLAM",
        triangulation_location="inRays",
        opt_rep_weight=1.0,
        opt_global_weight=1.0,
        opt_arap_weight=1e4,
        sim_depth_weight=300.0,
        n_optimizations=n_optimizations,
        n_opt_iterations=n_opt_iterations,
        nlopt_n_optimizations=nlopt_evals,
        nlopt_rel_tolerance=1e-2,
        nlopt_abs_tolerance=1e-2,
        nlopt_rep_lower=1.0,
        nlopt_rep_upper=1.0,
        nlopt_global_lower=1.0,
        nlopt_global_upper=1.0,
        nlopt_arap_lower=1e-5,
        nlopt_arap_upper=1e7,
        opt_selection="twoOptimizations",
        opt_weights_selection="nlopt",
    )
    if scene.size == 320:
        return base
    from .real_sweep import pair_config

    return pair_config(dataclasses.replace(base, n_features=1000, n_scales=8), "1024_00000_1229-1236",
                       "InRays", "no_checks")
