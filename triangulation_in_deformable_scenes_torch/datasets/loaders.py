"""Sequence loaders with a common interface and background prefetch.

Own copy of ``triangulation_in_deformable_scenes_tpu/datasets/loaders.py``
(numpy only; the torch package imports nothing of the JAX package). OpenCV
is imported lazily inside ``_cv2()``, so importing this module needs no
OpenCV: only reading frames from files does.

Parity with ``Modules/DatasetLoader/*``:

- ``DrunkardLoader`` (``DrunkardLoader.cc:10-89``): ``pose.txt`` rows
  ``t tx ty tz qx qy qz qw``; frames ``color/<t>.png`` + ``depth/<t>.png``.
- ``RealcolonLoader`` (``RealcolonLoader.cc:14-125``): comma-separated
  trajectory with 13 columns (timestamp, _, tx, ty, tz, qw, qx, qy, qz, ...);
  frames ``rgb/%04d.jpg`` (1-based) + ``depth_exr/%04d.exr`` (0-based).
- ``SyncolonLoader`` (``SyncolonLoader.cc:11-131``): ``;``-separated rows
  ``tx;ty;tz;qx;qy;qz;qw;t`` with translations divided by 10; EXR depth
  stored in clip space and inverted via 1/(z(1-d)+w) with near/far planes.

Deviation: Drunkard 16-bit depth PNGs are converted to float32 before use;
the reference reinterprets the raw buffer as float (``Frame.cc:112`` reads
``ptr<float>`` on whatever ``imread`` returned), which is only correct for
float inputs.

All loaders return numpy arrays; poses are returned as world-from-camera
(R_wc, t_wc) exactly as the Execution mains construct Twc from the rows
(``Execution/drunkard.cc:86-91``).
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")


def _cv2():
    import cv2

    return cv2


def _quat_to_R(qw, qx, qy, qz):
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


class _BaseLoader:
    """Index-based access + iterator with a one-frame prefetch thread."""

    def __init__(self):
        self.timestamps: list = []
        self.poses: list = []  # (R_wc [3,3], t_wc [3])
        self.rgb_paths: list = []
        self.depth_paths: list = []

    def __len__(self):
        return len(self.timestamps)

    def get_pose(self, idx):
        return self.poses[idx]

    def get_timestamp(self, idx):
        return self.timestamps[idx]

    def get_rgb(self, idx):
        cv2 = _cv2()
        return cv2.imread(self.rgb_paths[idx], cv2.IMREAD_UNCHANGED)

    def get_depth(self, idx):
        cv2 = _cv2()
        im = cv2.imread(self.depth_paths[idx], cv2.IMREAD_UNCHANGED)
        if im is None:
            return None
        return np.asarray(im, dtype=np.float32)

    def frames(self, start=0, end=None, step=1, prefetch=2):
        """Yield (idx, rgb, depth, (R_wc, t_wc), ts) with background IO."""
        end = len(self) - 1 if end is None else min(end, len(self) - 1)
        indices = list(range(start, end + 1, step))
        q: queue.Queue = queue.Queue(maxsize=prefetch)

        def worker():
            for i in indices:
                q.put((i, self.get_rgb(i), self.get_depth(i), self.get_pose(i), self.get_timestamp(i)))
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item


class DrunkardLoader(_BaseLoader):
    def __init__(self, folder_path: str, times_path: str):
        super().__init__()
        with open(times_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 8:
                    continue
                t = parts[0]
                tx, ty, tz, qx, qy, qz, qw = map(float, parts[1:8])
                self.timestamps.append(float(t))
                self.poses.append((_quat_to_R(qw, qx, qy, qz), np.array([tx, ty, tz])))
                self.rgb_paths.append(os.path.join(folder_path, "color", f"{t}.png"))
                self.depth_paths.append(os.path.join(folder_path, "depth", f"{t}.png"))


class RealcolonLoader(_BaseLoader):
    def __init__(self, folder_path: str, times_path: str):
        super().__init__()
        with open(times_path) as f:
            lines = f.readlines()[2:]  # two header lines skipped (ref :27-28)
        i = 0
        for line in lines:
            tokens = line.strip().split(",")
            if len(tokens) != 13:
                continue
            ts = float(tokens[0])
            tx, ty, tz = map(float, tokens[2:5])
            qw, qx, qy, qz = map(float, tokens[5:9])
            self.timestamps.append(ts)
            self.poses.append((_quat_to_R(qw, qx, qy, qz), np.array([tx, ty, tz])))
            self.rgb_paths.append(os.path.join(folder_path, "rgb", f"{i + 1:04d}.jpg"))
            self.depth_paths.append(os.path.join(folder_path, "depth_exr", f"{i:04d}.exr"))
            i += 1


class SyncolonLoader(_BaseLoader):
    near_clip = 0.01  # reference SyncolonLoader.h defaults
    far_clip = 20.0

    def __init__(self, folder_path: str, times_path: str, near_clip=None, far_clip=None):
        super().__init__()
        if near_clip is not None:
            self.near_clip = near_clip
        if far_clip is not None:
            self.far_clip = far_clip
        with open(times_path) as f:
            i = 0
            for line in f:
                tokens = line.strip().split(";")
                if len(tokens) != 8:
                    continue
                tx, ty, tz = (float(v) / 10.0 for v in tokens[0:3])
                qx, qy, qz, qw = map(float, tokens[3:7])
                ts = float(tokens[7])
                self.timestamps.append(ts)
                self.poses.append((_quat_to_R(qw, qx, qy, qz), np.array([tx, ty, tz])))
                self.rgb_paths.append(os.path.join(folder_path, "rgb", f"{i:04d}.png"))
                self.depth_paths.append(os.path.join(folder_path, "depth", f"{i:04d}.exr"))
                i += 1

    def get_depth(self, idx):
        cv2 = _cv2()
        im = cv2.imread(self.depth_paths[idx], cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if im is None:
            return None
        if im.ndim == 3:
            im = im[..., 2]  # reference takes channel 2 after split
        d = np.asarray(im, dtype=np.float32)
        # Clip-space inversion (SyncolonLoader.cc:97-115).
        x = 1.0 - self.far_clip / self.near_clip
        y = self.far_clip / self.near_clip
        z = x / self.far_clip
        w = y / self.far_clip
        return 1.0 / (z * (1.0 - d) + w)
