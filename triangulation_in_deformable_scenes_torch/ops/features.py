"""Image front end: FAST detection, orientation, ORB description.

Counterpart of ``triangulation_in_deformable_scenes_tpu/ops/features.py``
(the reference's ``Modules/Features/FAST.cc``, ``ORB.cc``), stage for stage
and under the same names: pyramid, FAST-9/16 score map, two-threshold cell
rule, 3x3 non-max suppression, masks dilated per octave, per-level top-k,
intensity-centroid angle over the r=15 circle, and the 256-pair rotated
BRIEF descriptor from one [43, 43] patch per keypoint (see that module's
docstring for the deviations from the reference it documents).

Plain torch ops on both devices: no TPU kernel lies on this path. Where the
JAX package was shaped by the TPU, the port takes the direct form of the
same function:

- the descriptor taps are a plain gather into the blurred patch, where JAX
  selects them with one-hot matmuls (``features.py:366-377``); both select
  the same values exactly;
- the contiguous-arc minima of the FAST score are a doubling min over the
  16 shifted differences instead of one [16, 9, H, W] gather (min is exact
  in any order);
- the 7x7 patch blur is a sum of seven shifted slices in a fixed order, so
  the card and the CPU blur alike.

Hazards handled here (ROADMAP Queue C):

- **Top-k ties.** FAST scores on 8-bit frames are integers, so ties are
  everywhere. ``jax.lax.top_k`` puts the lowest index first among equal
  values and ``torch.topk`` does not; ``topk_level`` takes the first k of a
  stable descending sort, which orders ties as JAX does.
- **Resampling.** ``jax.image.resize(..., "linear")`` antialiases when it
  downscales, with weight matrices that XLA rounds in its own way under
  ``jit``. ``resize_weights`` builds the same matrices (within a few ulp;
  equal at 1024 -> 853 and 1024 -> 711) and ``resize_linear`` applies them
  by two matrix products on the image's device, as JAX does; the products
  sum in other orders, so levels agree within 2e-4 grey levels, not bit for
  bit, and keypoints on levels >= 1 can still flip at a threshold or a tie.
- **Patches near edges.** ``dynamic_slice`` clamps its start in silence and
  ``DESC_R`` = 21 > ``EDGE`` = 19; ``_extract_patches`` instead checks that
  every valid centre lies at least ``DESC_R`` inside the padded level (the
  16 px detection margin guarantees it) and raises otherwise.

Descriptors are [M, 256] uint8 0/1 bits, as in JAX; only the matcher packs
them (``ops/match_scan.py``).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import FP

EDGE = 19  # reference EDGE_THRESHOLD
HALF_PATCH = 15
# The port's own copy of the OpenCV bit_pattern_31_ table (x0, y0, x1, y1).
_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))  # [256, 4]

# FAST-9/16 Bresenham circle, clockwise from 12 o'clock: (dy, dx).
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
_ARC = 9  # contiguous arc length for FAST-9/16


def _umax_table(r=HALF_PATCH) -> np.ndarray:
    """Circular-patch row extents, as the reference builds in the FAST ctor."""
    umax = np.zeros(r + 1, dtype=np.int32)
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(r * r - v * v)))
    v0 = 0
    for v in range(r, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


_UMAX = _umax_table()


def _circular_mask() -> np.ndarray:
    """[31, 31] inclusion mask of the orientation patch."""
    m = np.zeros((2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1), dtype=np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = _UMAX[abs(v)]
        m[v + HALF_PATCH, HALF_PATCH - d : HALF_PATCH + d + 1] = 1.0
    return m


_CMASK = _circular_mask()


def _gauss(ksize, sigma, dtype, device):
    """A ksize-tap Gaussian, normalised in f64 (``features.py:113-116``)."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.as_tensor(k / k.sum(), dtype=dtype, device=device)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of ``jax.image.resize(..., "linear")`` along
    one axis (``compute_weight_mat`` in jax's ``image/scale.py``), rounded as
    XLA rounds them under ``jit``: ``sample_f`` by one fused multiply-add,
    ``x`` by a multiply with the reciprocal of ``kernel_scale``, the column
    sums in row order."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    j = np.arange(n_out, dtype=np.float64) + 0.5
    sample_f = (j * np.float64(inv_scale) - 0.5).astype(np.float32)  # rounded once
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) * (np.float32(1.0) / kernel_scale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = np.cumsum(w, axis=0, dtype=np.float32)[-1]
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


_WEIGHTS = {}


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``resize_weights`` on ``device``, cached by sizes and device."""
    key = (n_in, n_out, str(device))
    if key not in _WEIGHTS:
        _WEIGHTS[key] = torch.as_tensor(resize_weights(n_in, n_out), device=device)
    return _WEIGHTS[key]


def resize_linear(im, shape):
    """Linear resampling of a [H, W] f32 image to ``shape``, antialiased when
    it downscales, as ``jax.image.resize(..., "linear")``: JAX's own weights
    (``resize_weights``) applied by two f32 matrix products on the image's
    device, rows first, as JAX contracts them outside any kernel."""
    shape = (int(shape[0]), int(shape[1]))
    if im.shape[0] != shape[0]:
        im = _weights(im.shape[0], shape[0], im.device).T @ im
    if im.shape[1] != shape[1]:
        im = im @ _weights(im.shape[1], shape[1], im.device)
    return im


def build_pyramid(im, n_scales: int, scale_factor: float):
    """Level-by-level linear downscaling (``FAST::computePyramid``)."""
    levels = [im]
    h, w = im.shape
    for level in range(1, n_scales):
        inv = 1.0 / (scale_factor**level)
        sz = (int(round(h * inv)), int(round(w * inv)))
        levels.append(resize_linear(levels[-1], sz))
    return levels


def gaussian_blur(im, ksize=7, sigma=2.0):
    """Separable Gaussian with a reflect pad (``ORB::computePyramid`` blurs
    7x7 sigma=2; ``features.py:111-120``)."""
    r = ksize // 2
    pad = F.pad(im[None, None], (r, r, r, r), mode="reflect")[0, 0]
    return _blur_valid(pad[None], ksize, sigma)[0]


def _blur_valid(x, ksize=7, sigma=2.0):
    """VALID separable Gaussian over the last two axes of [N, H, W]: a sum of
    ksize shifted slices, rows then columns, in a fixed order."""
    k = _gauss(ksize, sigma, x.dtype, x.device)
    w = x.shape[-1] - (ksize - 1)
    rows = k[0] * x[..., :, 0:w]
    for t in range(1, ksize):
        rows = rows + k[t] * x[..., :, t : t + w]
    h = x.shape[-2] - (ksize - 1)
    out = k[0] * rows[..., 0:h, :]
    for t in range(1, ksize):
        out = out + k[t] * rows[..., t : t + h, :]
    return out


def fast_score(im):
    """FAST-9/16 corner score for every pixel: max over the 16 contiguous
    9-arcs of the minimal absolute centre difference (a pixel is a corner at
    threshold t iff score > t); -inf on the 3 px frame."""
    d = torch.stack([torch.roll(im, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in _CIRCLE]) - im[None]

    def arc_min(x):
        # Doubling min over windows of 9 circularly contiguous offsets.
        m2 = torch.minimum(x, torch.roll(x, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        return torch.minimum(m8, torch.roll(x, -(_ARC - 1), dims=0))

    score = torch.maximum(arc_min(d).amax(dim=0), arc_min(-d).amax(dim=0))
    h, w = im.shape
    inb = torch.zeros((h, w), dtype=torch.bool, device=im.device)
    inb[3 : h - 3, 3 : w - 3] = True
    return torch.where(inb, score, torch.full_like(score, -math.inf))


def _cell_reduce_max(x, cell):
    h, w = x.shape
    ph = (-h) % cell
    pw = (-w) % cell
    xp = F.pad(x, (0, pw, 0, ph), value=-math.inf)
    hb, wb = xp.shape[0] // cell, xp.shape[1] // cell
    m = xp.reshape(hb, cell, wb, cell).amax(dim=(1, 3))
    up = m.repeat_interleave(cell, dim=0).repeat_interleave(cell, dim=1)
    return up[:h, :w]


def eligible_corners(score, th_high, th_low, cell=30):
    """Two-threshold-per-cell rule (FAST.cc:186-193) as a mask."""
    high = score > th_high
    cell_has_high = _cell_reduce_max(high.to(score.dtype), cell) > 0
    return high | ((~cell_has_high) & (score > th_low))


def nms3(score):
    """3x3 non-max suppression: score >= the max of its 8 neighbours (the
    max over the 3x3 window with the centre is the same test)."""
    return score >= F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]


def _shift0(x, s, axis):
    """Shift by ``s`` along ``axis`` with zeros shifted in (no wraparound)."""
    n = x.shape[axis]
    out = torch.zeros_like(x)
    if abs(s) >= n:
        return out
    if s > 0:
        out.narrow(axis, s, n - s).copy_(x.narrow(axis, 0, n - s))
    else:
        out.narrow(axis, 0, n + s).copy_(x.narrow(axis, -s, n + s))
    return out


def dilate_mask(mask, side):
    """Binary dilation with a side x side rect kernel by log-doubling
    shift-max, separably (``features.py:176-218``). Kernels larger than the
    image saturate and are clamped."""
    h, w = mask.shape
    side = int(min(side, 2 * max(h, w) + 1))
    r = side // 2
    x = mask.to(torch.float32)

    def dilate_axis(x, radius, axis):
        m = 0
        while 2 * m + 1 <= radius:
            s = m + 1
            x = torch.maximum(x, torch.maximum(_shift0(x, s, axis), _shift0(x, -s, axis)))
            m = 2 * m + 1
        rem = radius - m
        if rem > 0:
            x = torch.maximum(x, torch.maximum(_shift0(x, rem, axis), _shift0(x, -rem, axis)))
        return x

    if r > 0:
        x = dilate_axis(x, r, 0)
        x = dilate_axis(x, r, 1)
    return x > 0


def generate_masks(im, border_mask, n_scales: int, color_threshold=240.0):
    """Exclusion masks per octave (``FAST::GenerateMasks``): border mask OR
    specular reflections (> 240), dilated with side = ceil(2^(i+1)*(2.5/1.5))*2+5."""
    base = im > color_threshold
    if border_mask is not None:
        base = base | (border_mask > 0)
    masks = []
    max_scale = 1
    for _ in range(n_scales):
        max_scale *= 2
        side = int(np.ceil(max_scale * (2.5 / 1.5))) * 2 + 5
        masks.append(dilate_mask(base, side))
    return masks


def features_per_level(n_features: int, n_scales: int, scale_factor: float):
    """Geometric per-level budget (ORB-SLAM distribution used by the ref)."""
    f = 1.0 / scale_factor
    counts = [int(round(n_features * (1 - f) / (1 - f**n_scales) * (f**l))) for l in range(n_scales)]
    counts[-1] = max(n_features - sum(counts[:-1]), 0)
    return counts


class Keypoints(NamedTuple):
    xy: torch.Tensor  # [M, 2] f32 full-resolution (x, y)
    level_xy: torch.Tensor  # [M, 2] f32 coordinates in the level image
    octave: torch.Tensor  # [M] int32
    score: torch.Tensor  # [M] f32
    angle: torch.Tensor  # [M] f32 degrees
    desc: torch.Tensor  # [M, 256] uint8 0/1 bits
    valid: torch.Tensor  # [M] bool


def topk_level(score, mask, k):
    """Top-k corner positions of one level; returns (xy [k, 2] int64,
    score [k], ok [k]). Ties keep the lowest flat index first, as
    ``jax.lax.top_k`` does: the first k of a stable descending sort."""
    s = torch.where(mask, score, torch.full_like(score, -math.inf)).reshape(-1)
    vals, flat = torch.sort(s, descending=True, stable=True)
    vals, flat = vals[:k], flat[:k]
    w = score.shape[1]
    xy = torch.stack([flat % w, flat // w], dim=-1)
    return xy, vals, torch.isfinite(vals)


def ic_angle(im, xy, valid):
    """Intensity-centroid angle (degrees) for integer keypoints xy [N, 2]."""
    return ic_angle_from_patches(_extract_patches(im, xy, HALF_PATCH, valid), valid)


def ic_angle_from_patches(patch, valid):
    """IC angle from pre-gathered [N, 31, 31] patches (FAST::IC_Angle)."""
    u = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=patch.dtype, device=patch.device)
    cm = torch.as_tensor(_CMASK, dtype=patch.dtype, device=patch.device)
    m10 = (patch * (u[None, :] * cm)).sum(dim=(1, 2))
    m01 = (patch * (u[:, None] * cm)).sum(dim=(1, 2))
    ang = torch.atan2(m01, m10) * (180.0 / math.pi)
    ang = torch.where(ang < 0, ang + 360.0, ang)
    return torch.where(valid, ang, torch.zeros_like(ang))


def _extract_patches(im, xy, r, valid):
    """Gather (2r+1)^2 patches around integer centres xy [N, 2] (x, y).

    Every valid centre must lie at least ``r`` inside ``im`` (the detection
    margin plus the EDGE pad guarantee it for ``DESC_R``); a violation raises
    instead of being clamped. Invalid centres, whose outputs are masked, are
    clamped into range."""
    h, w = im.shape
    cx, cy = xy[:, 0], xy[:, 1]
    inside = (cx >= r) & (cx < w - r) & (cy >= r) & (cy < h - r)
    if bool((valid & ~inside).any()):
        raise ValueError(f"a keypoint lies within {r} px of the padded level's edge")
    cx = cx.clamp(r, w - 1 - r)
    cy = cy.clamp(r, h - 1 - r)
    off = torch.arange(-r, r + 1, device=im.device)
    rows = (cy[:, None] + off)[:, :, None]
    cols = (cx[:, None] + off)[:, None, :]
    return im[rows, cols]


def _tap_offsets(angle):
    """Rotated-BRIEF tap offsets (ry, rx) [N, 512] of the 256 pairs' two
    endpoints (``features.py:354-364``)."""
    pat = torch.as_tensor(_PATTERN, dtype=FP, device=angle.device)
    rad = angle * (math.pi / 180.0)
    a, b = torch.cos(rad), torch.sin(rad)
    px = torch.cat([pat[:, 0], pat[:, 2]])
    py = torch.cat([pat[:, 1], pat[:, 3]])
    ry = torch.round(px[None, :] * b[:, None] + py[None, :] * a[:, None]).to(torch.int64)
    rx = torch.round(px[None, :] * a[:, None] - py[None, :] * b[:, None]).to(torch.int64)
    return ry, rx


def orb_descriptors(im_blur, xy, angle, valid):
    """Rotated-BRIEF bits [N, 256] from a blurred level (``ORB::computeORBDescriptor``)."""
    ry, rx = _tap_offsets(angle)
    t = im_blur[xy[:, 1:2] + ry, xy[:, 0:1] + rx]  # [N, 512]
    bits = (t[:, :256] < t[:, 256:]).to(torch.uint8)
    return torch.where(valid[:, None], bits, torch.zeros_like(bits))


# Descriptor tap radius: rotated and rounded taps of bit_pattern_31_ reach
# +-18; the 7x7 blur needs 3 more (``features.py:309-316``).
TAP_R = 18
DESC_R = TAP_R + 3  # 21


def blur_patches(patches):
    """VALID-mode separable 7x7 sigma-2 Gaussian over [N, 43, 43] patches
    -> [N, 37, 37] (``features.py:319-342``)."""
    return _blur_valid(patches)


def orb_descriptors_from_patches(patches_blur, angle, valid):
    """Rotated-BRIEF bits [N, 256] from blurred [N, 37, 37] patches: the
    taps are a plain gather inside each patch."""
    ry, rx = _tap_offsets(angle)
    n = patches_blur.shape[0]
    side = patches_blur.shape[-1]
    flat = patches_blur.reshape(n, side * side)
    t = torch.gather(flat, 1, (ry + TAP_R) * side + (rx + TAP_R))  # [N, 512]
    bits = (t[:, :256] < t[:, 256:]).to(torch.uint8)
    return torch.where(valid[:, None], bits, torch.zeros_like(bits))


def extract_level(im_level, mask_level, k: int, th_high: float, th_low: float, cell: int = 30):
    """Full per-level extraction: score -> cell thresholds -> NMS -> top-k ->
    orientation -> descriptors. ``im_level`` is unpadded; ``mask_level``
    True means excluded."""
    score = fast_score(im_level)
    keep = eligible_corners(score, th_high, th_low, cell) & nms3(score) & (~mask_level)
    # Detection margin: 16 px from the level edge (EDGE-3 on the padded image).
    h, w = im_level.shape
    margin = torch.zeros((h, w), dtype=torch.bool, device=im_level.device)
    margin[16 : h - 16, 16 : w - 16] = True
    keep = keep & margin

    xy, vals, ok = topk_level(score, keep, k)
    impad = F.pad(im_level[None, None], (EDGE, EDGE, EDGE, EDGE), mode="reflect")[0, 0]
    P = _extract_patches(impad, xy + EDGE, DESC_R, ok)  # [k, 43, 43]
    c = DESC_R - HALF_PATCH
    ang = ic_angle_from_patches(P[:, c:-c, c:-c], ok)
    desc = orb_descriptors_from_patches(blur_patches(P), ang, ok)
    return xy, vals, ok, ang, desc


def extract(
    im,
    n_features: int,
    n_scales: int,
    scale_factor: float,
    th_high: float = 20.0,
    th_low: float = 7.0,
    border_mask=None,
    device="cuda",
) -> Keypoints:
    """Multi-scale extraction over the pyramid; returns padded Keypoints on
    ``device`` (a tensor ``im`` keeps its own device). ``im`` is [H, W] in
    0..255; total capacity = sum of per-level budgets (== n_features)."""
    if not isinstance(im, torch.Tensor):
        im = torch.as_tensor(np.asarray(im, dtype=np.float32), device=device)
    im = im.to(torch.float32)
    if border_mask is not None:
        border_mask = torch.as_tensor(np.asarray(border_mask), device=im.device)
    pyramid = build_pyramid(im, n_scales, scale_factor)
    masks = generate_masks(im, border_mask, n_scales)
    budgets = features_per_level(n_features, n_scales, scale_factor)

    outs = []
    for level, (lvl_im, budget) in enumerate(zip(pyramid, budgets)):
        if budget <= 0:
            continue
        scale = scale_factor**level
        mask_l = resize_linear(masks[level].to(torch.float32), lvl_im.shape) > 0.5
        xy, vals, ok, ang, desc = extract_level(lvl_im, mask_l, budget, th_high, th_low)
        xyf = xy.to(FP)
        outs.append(
            Keypoints(
                xy=xyf * scale,
                level_xy=xyf,
                octave=torch.full((budget,), level, dtype=torch.int32, device=im.device),
                score=vals,
                angle=ang,
                desc=desc,
                valid=ok,
            )
        )
    return Keypoints(*[torch.cat([getattr(o, f) for o in outs], dim=0) for f in Keypoints._fields])
