"""Frame visualizer: features / matches / triangulated matches as PNG dumps.

Rebuilds ``Modules/Visualization/FrameVisualizer.{h,cc}`` headless: each
``draw*`` method renders the same overlay the reference shows in an OpenCV
window (green circles for keypoints, lines between match pairs on a
side-by-side canvas, red marks for triangulated matches) and writes it to
``<out_dir>/<name>_<serial>.png``. Disabled (``show_scene=False``) it is a
no-op, mirroring the reference's flag gating (``Settings.cc:155-189``).
"""

from __future__ import annotations

import os

import numpy as np

from . import draw


class FrameVisualizer:
    def __init__(self, enabled: bool = True, out_dir: str = "./viz"):
        self.enabled = bool(enabled)
        self.out_dir = out_dir
        self._ref_kp = None
        self._ref_im = None
        self._serial = 0
        if self.enabled:
            os.makedirs(out_dir, exist_ok=True)

    # -- reference-frame bookkeeping (FrameVisualizer::setReferenceFrame) ----

    def set_reference_frame(self, kp, im) -> None:
        if not self.enabled:
            return
        self._ref_kp = np.asarray(kp, dtype=np.float64)
        self._ref_im = draw.to_rgb(im)

    def _emit(self, name: str, canvas: np.ndarray) -> str:
        path = os.path.join(self.out_dir, f"{name}_{self._serial:05d}.png")
        draw.write_png(path, canvas)
        self._serial += 1
        return path

    # -- drawing entry points (names mirror FrameVisualizer.h:40-78) --------

    def draw_features(self, kp, im, valid=None, name: str = "features"):
        """Green circles on every (valid) keypoint
        (``FrameVisualizer::drawFeatures``)."""
        if not self.enabled:
            return None
        canvas = draw.to_rgb(im)
        kp = np.asarray(kp, dtype=np.float64)
        ok = np.ones(len(kp), dtype=bool) if valid is None else np.asarray(valid, dtype=bool)
        for (x, y), v in zip(kp, ok):
            if v:
                draw.draw_circle(canvas, x, y, 3, draw.GREEN)
        return self._emit(name, canvas)

    def draw_frame_matches(self, kp_cur, im_cur, matches, name: str = "matches"):
        """Side-by-side reference/current canvas with match lines
        (``FrameVisualizer::drawFrameMatches``). ``matches[i]`` is the current
        index matched to reference key i, -1 if unmatched."""
        if not self.enabled or self._ref_im is None:
            return None
        return self.draw_matches(self._ref_kp, self._ref_im, kp_cur, im_cur, matches, name)

    def draw_matches(self, kp1, im1, kp2, im2, matches, name: str = "matches"):
        """(``FrameVisualizer::drawMatches``) two images stacked horizontally,
        matched keypoints joined by yellow lines."""
        if not self.enabled:
            return None
        c1 = draw.to_rgb(im1)
        c2 = draw.to_rgb(im2)
        canvas = draw.hstack_images(c1, c2)
        off = c1.shape[1]
        kp1 = np.asarray(kp1, dtype=np.float64)
        kp2 = np.asarray(kp2, dtype=np.float64)
        for i, j in enumerate(np.asarray(matches)):
            if j < 0:
                continue
            x1, y1 = kp1[i]
            x2, y2 = kp2[int(j)]
            draw.draw_circle(canvas, x1, y1, 3, draw.GREEN)
            draw.draw_circle(canvas, x2 + off, y2, 3, draw.GREEN)
            draw.draw_line(canvas, x1, y1, x2 + off, y2, draw.YELLOW)
        return self._emit(name, canvas)

    def draw_triangulated_matches(
        self, kp_cur, im_cur, matches, triangulated, name: str = "triangulated"
    ):
        """(``FrameVisualizer::drawFrameTriangulatedMatches``) matches that
        produced map points are drawn in red, the rest in green."""
        if not self.enabled:
            return None
        canvas = draw.to_rgb(im_cur)
        kp_cur = np.asarray(kp_cur, dtype=np.float64)
        tri = np.asarray(triangulated, dtype=bool)
        for i, j in enumerate(np.asarray(matches)):
            if j < 0:
                continue
            x, y = kp_cur[int(j)]
            color = draw.RED if tri[i] else draw.GREEN
            draw.draw_circle(canvas, x, y, 3, color)
        return self._emit(name, canvas)

    def draw_depth_image(self, depth, name: str = "depth"):
        """(``FrameVisualizer::drawFrameDepthImage``) normalized-gray dump."""
        if not self.enabled:
            return None
        d = np.asarray(depth, dtype=np.float64)
        finite = np.isfinite(d)
        lo = d[finite].min() if finite.any() else 0.0
        hi = d[finite].max() if finite.any() else 1.0
        norm = np.where(finite, (d - lo) / max(hi - lo, 1e-12), 0.0)
        return self._emit(name, draw.to_rgb(norm * 255.0))
