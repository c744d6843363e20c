"""Dataset preparation tools for RealColon / Syncolon.

The port's own copy of ``triangulation_in_deformable_scenes_tpu/harness/prep.py``
(host-only OpenCV code; the port imports nothing of the JAX package), which
reimplements the reference's offline prep scripts with paths as arguments:

- ``realcolon_resize_depths_exr``: ``Data/Scripts/realcolon/resizeDepthsExr.py``
  -- embed 992x1344 .npy depth maps into the 1080x1440 frame (top-centered
  vertically, left offset 73), zero the endoscope border via the mask image,
  write 32-bit float EXR.
- ``realcolon_crop_center``: ``Data/Scripts/realcolon/crop.py`` -- crop RGB
  frames to (70, 0, 1420, 1080) then center-crop to 1344x992.
- ``resize_images``: ``Data/Scripts/realcolon/{decreaseRes,increaseRes}.py``
  -- nearest-neighbor resize of every image in a folder (used for both RGB
  and depth maps; nearest preserves depth values).
- ``syncolon_exr_to_png``: ``Data/Scripts/syncolon/convertToPng.py`` -- read
  the R channel of an EXR depth map and store it as 16-bit PNG with the
  30 / (2^16 - 1) scale factor.

All functions require OpenCV; they raise ImportError without it.
"""

from __future__ import annotations

import os

import numpy as np

# RealColon geometry constants (resizeDepthsExr.py:14-30).
FINAL_HEIGHT, FINAL_WIDTH = 1080, 1440
DEPTH_HEIGHT, DEPTH_WIDTH = 992, 1344
DEPTH_TOP = (FINAL_HEIGHT - DEPTH_HEIGHT) // 2
DEPTH_LEFT = 73

# Syncolon depth PNG quantization (convertToPng.py:40-42).
SYNCOLON_DEPTH_SCALE = 30.0 / (2**16 - 1)


def _cv2():
    try:
        import cv2

        return cv2
    except ImportError as e:  # pragma: no cover
        raise ImportError("dataset prep tools require OpenCV (cv2)") from e


def realcolon_resize_depths_exr(input_folder, output_folder, border_mask_path):
    """Embed npy depth maps into full frames and mask the endoscope border."""
    cv2 = _cv2()
    os.makedirs(output_folder, exist_ok=True)
    mask = cv2.imread(border_mask_path, cv2.IMREAD_GRAYSCALE)
    if mask is None:
        raise FileNotFoundError(border_mask_path)
    border_mask = (mask == 0).astype(np.float32)  # 1 = valid, 0 = border

    written = []
    for filename in sorted(os.listdir(input_folder)):
        if not filename.endswith(".npy"):
            continue
        depth = np.squeeze(np.load(os.path.join(input_folder, filename))).astype(np.float32)
        if depth.shape != (DEPTH_HEIGHT, DEPTH_WIDTH):
            raise ValueError(
                f"unexpected depth shape {depth.shape}, expected {(DEPTH_HEIGHT, DEPTH_WIDTH)}"
            )
        frame = np.zeros((FINAL_HEIGHT, FINAL_WIDTH), dtype=np.float32)
        frame[DEPTH_TOP : DEPTH_TOP + DEPTH_HEIGHT, DEPTH_LEFT : DEPTH_LEFT + DEPTH_WIDTH] = depth
        frame *= border_mask
        out = os.path.join(output_folder, filename.replace(".npy", ".exr"))
        cv2.imwrite(out, frame, [cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_FLOAT])
        written.append(out)
    return written


def realcolon_crop_center(input_folder, output_folder):
    """Crop (70, 0, 1420, 1080), then center-crop to 1344x992 (crop.py)."""
    cv2 = _cv2()
    os.makedirs(output_folder, exist_ok=True)
    written = []
    for filename in sorted(os.listdir(input_folder)):
        if not filename.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            continue
        im = cv2.imread(os.path.join(input_folder, filename), cv2.IMREAD_COLOR)
        if im is None:
            continue
        im = im[0:1080, 70 : 70 + 1350]
        h, w = im.shape[:2]
        left = (w - DEPTH_WIDTH) // 2
        top = (h - DEPTH_HEIGHT) // 2
        im = im[top : top + DEPTH_HEIGHT, left : left + DEPTH_WIDTH]
        out = os.path.join(output_folder, filename)
        cv2.imwrite(out, im)
        written.append(out)
    return written


def resize_images(input_folder, output_folder, width, height):
    """Nearest-neighbor resize (decreaseRes.py / increaseRes.py semantics)."""
    cv2 = _cv2()
    os.makedirs(output_folder, exist_ok=True)
    written = []
    for filename in sorted(os.listdir(input_folder)):
        im = cv2.imread(os.path.join(input_folder, filename), cv2.IMREAD_UNCHANGED)
        if im is None:
            continue
        resized = cv2.resize(im, (width, height), interpolation=cv2.INTER_NEAREST)
        out = os.path.join(output_folder, filename)
        cv2.imwrite(out, resized)
        written.append(out)
    return written


def syncolon_exr_to_png(exr_folder, png_folder, files=None):
    """EXR R-channel depth -> 16-bit PNG with the syncolon scale factor."""
    cv2 = _cv2()
    os.makedirs(png_folder, exist_ok=True)
    names = files if files is not None else sorted(
        f for f in os.listdir(exr_folder) if f.endswith(".exr")
    )
    written = []
    for name in names:
        depth = cv2.imread(
            os.path.join(exr_folder, name), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_UNCHANGED
        )
        if depth is None:
            continue
        if depth.ndim == 3:  # R channel holds the depth (convertToPng.py:33)
            depth = depth[..., -1]
        scaled = np.clip(depth.astype(np.float64) / SYNCOLON_DEPTH_SCALE, 0, 65535).astype(
            np.uint16
        )
        out = os.path.join(png_folder, name.replace(".exr", ".png"))
        cv2.imwrite(out, scaled)
        written.append(out)
    return written
