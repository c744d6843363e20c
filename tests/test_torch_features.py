"""The port's image front end (ops/features.py) against the JAX package's.

Same inputs, made with numpy from a seed, through both packages on the CPU.
Tolerances:

- integer-valued stages (FAST score, cell rule, NMS, masks) are exact: their
  arithmetic on 8-bit images is exact in f32;
- the resampling weights: the port's ``resize_weights`` against the
  matrices that ``jax.image.resize`` builds under ``jit`` (XLA fuses
  ``sample_f`` into one FMA and multiplies by ``1 / kernel_scale``), in ulp
  of f32: equal at 1024 -> 853 and 1024 -> 711, at most 3 at 853 -> 711
  (17 entries in 7 columns, where XLA's normalisation rounds otherwise);
- the pyramid: 2e-4 grey levels (the same weights; JAX contracts them by
  matmul, the port by a band in row order, so the sums round in other
  orders; measured 1.07e-4 on this frame, 6.6e-4 before the port took
  JAX's weights);
- angles 1e-3 deg on patches of resampled levels (a few ulp: the port sums
  the moments in the order XLA's jitted matrix-vector product does, but
  torch's and XLA's atan2 may differ in the last ulp), at most 2 ulp on the
  extraction of JAX's own levels;
- the patch blur: bit for bit (the port sums the seven taps in the order
  XLA's CPU convolution does: ((p0 + p1) + (p2 + p3)) + (p4 + p5), then p6);
- descriptors from identical blurred patches and angles: bit for bit; from
  the full-image formulation at most 0.5 % of bits differ (cos/sin of the
  angle may differ by an ulp and move a tap at .5, the tolerance
  tests/test_features.py:151-182 allows between two JAX formulations);
- ``extract_level`` on JAX's jitted pyramid levels of both full-width step
  frames: keypoints, scores, octaves and masks equal, angles within 2 ulp,
  descriptors bit for bit;
- ``extract`` on the 320 x 320 step scene: level-0 keypoints identical, 99 %
  of all keypoints identical, 99.5 % of descriptor bits equal on the shared
  keypoints (resampling differences flip ties of taps in flat regions on the
  upper levels: ~0.3 % measured).

Run as a script, it prints the readings behind PERF.md's stage-0 finding:
the per-level comparison of ``extract_level`` on JAX's levels of both
full-width frames (``--before``: with the blur and moment sums the port used
until it took XLA's orders), and ``--search``: the search that found those
orders (every summation tree of the seven blur taps with every placement of
fused multiply-adds against ``jax.jit(blur_patches)``, about 15 minutes; and
vector-accumulator schemes for the moments against the jitted einsum):

    JAX_PLATFORMS=cpu python tests/test_torch_features.py [--before] [--search]
"""

import itertools
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangulation_in_deformable_scenes_torch.harness import step_scene
from triangulation_in_deformable_scenes_torch.ops import features as TF
from triangulation_in_deformable_scenes_torch.pipeline.sequence import to_grayscale
from triangulation_in_deformable_scenes_tpu.ops import features as JF

torch.set_num_threads(1)


def integer_image(seed=0, h=96, w=128):
    """8-bit texture: rectangles over a gradient plus a little noise."""
    rng = np.random.default_rng(seed)
    im = np.tile(np.linspace(60, 120, w), (h, 1))
    for _ in range(40):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 10)
        hh, ww = rng.integers(4, 20, size=2)
        im[y : y + hh, x : x + ww] = rng.uniform(0, 255)
    im = im + rng.integers(-3, 4, size=im.shape)
    return np.clip(np.round(im), 0, 255).astype(np.float32)


def scene_gray(scene=step_scene.SMALL):
    return step_scene.step_frames(scene)[0][0][..., 0].astype(np.float32)


def t(x):
    return torch.as_tensor(np.array(x))


def test_orb_pattern_is_the_same_table():
    np.testing.assert_array_equal(TF._PATTERN, JF._PATTERN)
    np.testing.assert_array_equal(TF._CMASK, JF._CMASK)


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_score_exact(seed):
    im = integer_image(seed)
    np.testing.assert_array_equal(TF.fast_score(t(im)).numpy(), np.asarray(JF.fast_score(jnp.asarray(im))))


def test_eligible_corners_and_nms_exact():
    im = integer_image(2)
    score = np.asarray(JF.fast_score(jnp.asarray(im)))
    want = np.asarray(JF.eligible_corners(jnp.asarray(score), 20.0, 7.0, 30))
    got = TF.eligible_corners(t(score), 20.0, 7.0, 30).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(TF.nms3(t(score)).numpy(), np.asarray(JF.nms3(jnp.asarray(score))))


@pytest.mark.parametrize("with_border", [False, True])
def test_generate_masks_exact(with_border):
    rng = np.random.default_rng(3)
    im = integer_image(3, h=160, w=200)
    im[40:48, 60:75] = 250.0  # specular blobs
    im[120:123, 10:14] = 255.0
    border = None
    if with_border:
        border = np.zeros(im.shape, np.uint8)
        border[:, :6] = 255
        border[rng.integers(0, 160, 5), rng.integers(0, 200, 5)] = 1
    want = JF.generate_masks(jnp.asarray(im), None if border is None else jnp.asarray(border), 5)
    got = TF.generate_masks(t(im), None if border is None else t(border), 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_in,n_out,max_ulp", [(1024, 853, 0), (1024, 711, 0), (853, 711, 3)])
def test_resize_weights_match_jitted_jax(n_in, n_out, max_ulp):
    import jax
    from jax._src.image import scale as jax_scale

    want = np.asarray(jax.jit(lambda: jax_scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_triangle_kernel, True))())
    got = TF.resize_weights(n_in, n_out)
    assert got.dtype == np.float32 and got.shape == want.shape == (n_in, n_out)
    assert (got >= 0).all() and (want >= 0).all()
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= max_ulp


def test_build_pyramid_close():
    im = scene_gray()
    want = JF.build_pyramid(jnp.asarray(im), 4, 1.2)
    got = TF.build_pyramid(t(im), 4, 1.2)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-4)


def test_features_per_level_same():
    for n, s in ((600, 4), (1000, 8), (300, 1)):
        assert TF.features_per_level(n, s, 1.2) == JF.features_per_level(n, s, 1.2)


def test_topk_level_keeps_jax_tie_order():
    """A score map full of equal values: the port picks the same k positions
    in the same order as jax.lax.top_k (lowest index first), which
    torch.topk does not."""
    rng = np.random.default_rng(4)
    score = rng.integers(0, 6, size=(40, 50)).astype(np.float32)
    mask = rng.uniform(size=score.shape) > 0.2
    k = 200
    jxy, jv, jok = (np.asarray(a) for a in JF.topk_level(jnp.asarray(score), jnp.asarray(mask), k))
    txy, tv, tok = TF.topk_level(t(score), t(mask), k)
    np.testing.assert_array_equal(txy.numpy(), jxy)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tok.numpy(), jok)
    s = torch.where(t(mask), t(score), torch.tensor(-np.inf)).reshape(-1)
    flat_topk = torch.topk(s, k).indices.numpy()
    assert not np.array_equal(flat_topk, jxy[:, 1] * score.shape[1] + jxy[:, 0])


def _ulps(a, b):
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))


def _jax_patches(level=1):
    """JAX's own [N, 43, 43] patches, angles and validity on one level of the
    step scene (a resampled level, so the values are not integers)."""
    im = jnp.asarray(scene_gray())
    lvl = JF.build_pyramid(im, level + 1, 1.2)[level]
    score = JF.fast_score(lvl)
    keep = JF.eligible_corners(score, 20.0, 7.0) & JF.nms3(score)
    h, w = lvl.shape
    yy, xx = jnp.arange(h)[:, None], jnp.arange(w)[None, :]
    keep = keep & (yy >= 16) & (yy < h - 16) & (xx >= 16) & (xx < w - 16)
    xy, _, ok = JF.topk_level(score, keep, 120)
    P = JF._extract_patches(jnp.pad(lvl, JF.EDGE, mode="reflect"), xy + JF.EDGE, JF.DESC_R)
    c = JF.DESC_R - JF.HALF_PATCH
    ang = JF.ic_angle_from_patches(P[:, c:-c, c:-c], ok)
    return np.asarray(P), np.asarray(ang), np.asarray(ok)


def test_ic_angle_from_patches_close():
    P, ang, ok = _jax_patches()
    c = JF.DESC_R - JF.HALF_PATCH
    got = TF.ic_angle_from_patches(t(P[:, c:-c, c:-c]), t(ok)).numpy()
    assert ok.sum() > 50
    d = np.abs(got - ang)
    d = np.minimum(d, 360.0 - d)
    assert d.max() < 1e-3


def test_blur_patches_close():
    P, _, _ = _jax_patches()
    want = np.asarray(JF.blur_patches(jnp.asarray(P)))
    got = TF.blur_patches(t(P)).numpy()
    assert got.shape == want.shape == (P.shape[0], 37, 37)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["step_scene", "blocky", "uniform"])
def test_blur_patches_matches_jax_bitwise(kind):
    """The port's seven-tap sums against ``jax.jit(blur_patches)``: equal bit
    for bit on the step scene's patches (a resampled level), on piecewise-flat
    random patches (where equal taps make the order show) and on uniform
    ones."""
    rng = np.random.default_rng(3)
    if kind == "step_scene":
        P = _jax_patches()[0]
    elif kind == "blocky":
        P = rng.integers(0, 256, size=(200, 11, 11)).astype(np.float32)
        P = np.repeat(np.repeat(P, 4, 1), 4, 2)[:, :43, :43].copy()
    else:
        P = rng.uniform(0, 255, size=(200, 43, 43)).astype(np.float32)
    want = np.asarray(jax.jit(JF.blur_patches)(jnp.asarray(P)))
    np.testing.assert_array_equal(TF.blur_patches(t(P)).numpy(), want)


@pytest.mark.cuda
def test_blur_and_moments_on_card_equal_the_cpu():
    """The blur and the angle moments are plain torch ops in XLA's order, so
    the card gives the CPU's values bit for bit (no FMA contraction: every
    multiply and add is its own op)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    P, _, ok = _jax_patches()
    np.testing.assert_array_equal(TF.blur_patches(t(P).cuda()).cpu().numpy(), TF.blur_patches(t(P)).numpy())
    c = TF.DESC_R - TF.HALF_PATCH
    Pc = t(np.ascontiguousarray(P[:, c:-c, c:-c]))
    w = torch.randn(2, Pc.shape[1] * Pc.shape[2], generator=torch.Generator().manual_seed(0))
    flat = Pc.reshape(len(Pc), -1)
    np.testing.assert_array_equal(TF._xla_gemv(flat.cuda(), w.cuda()).cpu().numpy(), TF._xla_gemv(flat, w).numpy())
    assert _ulps(TF.ic_angle_from_patches(Pc.cuda(), t(ok).cuda()).cpu().numpy(),
                 TF.ic_angle_from_patches(Pc, t(ok)).numpy()).max() <= 2


def test_orb_descriptors_from_jax_patches():
    """Given JAX's own blurred patches and angles, the port's bits are JAX's
    exactly."""
    P, ang, ok = _jax_patches()
    Pb = JF.blur_patches(jnp.asarray(P))
    want = np.asarray(JF.orb_descriptors_from_patches(Pb, jnp.asarray(ang), jnp.asarray(ok)))
    got = TF.orb_descriptors_from_patches(t(np.asarray(Pb)), t(ang), t(ok)).numpy()
    assert got.dtype == np.uint8 and got.shape == (len(ok), 256)
    np.testing.assert_array_equal(got, want)


def _levels_compared(frame):
    """JAX's jitted ``extract_level`` and the port's on JAX's jitted pyramid
    levels of one full-width step frame (1000 features, 8 scales); yields
    (level, JAX outputs, port outputs) as numpy arrays."""
    cfg = step_scene.scene_config(step_scene.FULL)
    gray = to_grayscale(step_scene.step_frames(step_scene.FULL)[frame][0]).astype(np.float32)
    levels = jax.jit(lambda im: JF.build_pyramid(im, cfg.n_scales, cfg.scale_factor))(jnp.asarray(gray))
    masks = JF.generate_masks(jnp.asarray(gray), None, cfg.n_scales)
    budgets = JF.features_per_level(cfg.n_features, cfg.n_scales, cfg.scale_factor)
    level_j = jax.jit(JF.extract_level, static_argnums=(2, 3, 4))
    for lvl, (im, k) in enumerate(zip(levels, budgets)):
        m = np.asarray(JF.resize_linear(masks[lvl].astype(jnp.float32), im.shape) > 0.5)
        want = [np.asarray(v) for v in level_j(im, jnp.asarray(m), k, 20.0, 7.0)]
        got = [v.numpy() for v in TF.extract_level(t(im), t(m), k, 20.0, 7.0)]
        yield lvl, want, got


@pytest.mark.parametrize("frame", [0, 1])
def test_extract_level_on_jax_levels(frame):
    """Both packages' ``extract_level`` on JAX's jitted pyramid levels of one
    full-width step frame: keypoints, scores and masks equal on every level,
    angles within 2 ulp, descriptor bits equal."""
    for lvl, (xy_j, s_j, ok_j, ang_j, d_j), (xy_t, s_t, ok_t, ang_t, d_t) in _levels_compared(frame):
        np.testing.assert_array_equal(xy_t, xy_j, err_msg=f"level {lvl}")
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert ok_j.sum() > 0
        assert _ulps(ang_t, ang_j).max() <= 2, f"level {lvl}"
        np.testing.assert_array_equal(d_t, d_j, err_msg=f"level {lvl}")


def test_full_image_forms_match_jax():
    """``ic_angle`` over the padded level, ``gaussian_blur`` and
    ``orb_descriptors`` (the full-image formulation both packages keep beside
    the patch path) on an 8-bit image against JAX: angles 1e-3 deg, blur
    1e-4 (~3e-5 measured), descriptors from JAX's blurred level and angles
    at most 0.5 % of bits apart."""
    rng = np.random.default_rng(7)
    im = np.round(rng.uniform(0, 255, size=(120, 160))).astype(np.float32)
    n = 64
    xy = np.stack([rng.integers(16, 160 - 16, size=n), rng.integers(16, 120 - 16, size=n)], -1) + JF.EDGE
    ok = np.ones(n, bool)
    pad_j = jnp.pad(jnp.asarray(im), JF.EDGE, mode="reflect")
    pad_t = torch.nn.functional.pad(t(im)[None, None], (TF.EDGE,) * 4, mode="reflect")[0, 0]
    np.testing.assert_array_equal(pad_t.numpy(), np.asarray(pad_j))
    ang_j = np.asarray(JF.ic_angle(pad_j, jnp.asarray(xy), jnp.asarray(ok)))
    ang_t = TF.ic_angle(pad_t, t(xy), t(ok)).numpy()
    d = np.abs(ang_t - ang_j)
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    blur_j = JF.gaussian_blur(pad_j)
    np.testing.assert_allclose(TF.gaussian_blur(pad_t).numpy(), np.asarray(blur_j), rtol=0, atol=1e-4)
    want = np.asarray(JF.orb_descriptors(blur_j, jnp.asarray(xy), jnp.asarray(ang_j), jnp.asarray(ok)))
    got = TF.orb_descriptors(t(np.asarray(blur_j)), t(xy), t(ang_j), t(ok)).numpy()
    assert (got != want).mean() <= 0.005


def test_patch_gather_refuses_centres_near_the_edge():
    """Where JAX's dynamic_slice would clamp a valid centre in silence, the
    port raises; invalid centres are clamped (their outputs are masked)."""
    im = torch.zeros(60, 60)
    xy = torch.tensor([[30, 30], [5, 30]])
    TF._extract_patches(im, xy, TF.DESC_R, torch.tensor([True, False]))
    with pytest.raises(ValueError):
        TF._extract_patches(im, xy, TF.DESC_R, torch.tensor([True, True]))


def test_extract_matches_jax_on_the_step_scene():
    im = scene_gray()
    kj = JF.extract(im, n_features=600, n_scales=4, scale_factor=1.2)
    kj = {k: np.asarray(v) for k, v in kj._asdict().items()}
    kt = TF.extract(im, n_features=600, n_scales=4, scale_factor=1.2, device="cpu")
    kt = {k: v.numpy() for k, v in kt._asdict().items()}
    assert kt["desc"].dtype == np.uint8 and kt["octave"].dtype == np.int32
    for k in kj:
        assert kt[k].shape == kj[k].shape, k
    same = (kt["level_xy"] == kj["level_xy"]).all(-1) & (kt["valid"] == kj["valid"]) & (
        kt["octave"] == kj["octave"])
    lvl0 = kj["octave"] == 0
    assert same[lvl0].all()
    np.testing.assert_array_equal(kt["xy"][lvl0], kj["xy"][lvl0])
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(kt["xy"][same], kj["xy"][same])
    shared = same & kj["valid"]
    assert shared.sum() > 400
    assert (kt["desc"][shared] == kj["desc"][shared]).mean() >= 0.995


# --------------------------------------------------------------- script mode


def _before_blur(x, ksize=7, sigma=2.0):
    """The blur the port used before it took XLA's order: seven shifted
    slices summed in tap order, rows then columns."""
    k = TF._gauss(ksize, sigma, x.dtype, x.device)
    w, h = x.shape[-1] - (ksize - 1), x.shape[-2] - (ksize - 1)
    rows = k[0] * x[..., :, 0:w]
    for i in range(1, ksize):
        rows = rows + k[i] * x[..., :, i : i + w]
    out = k[0] * rows[..., 0:h, :]
    for i in range(1, ksize):
        out = out + k[i] * rows[..., i : i + h, :]
    return out


def _before_angle(patch, valid):
    """The angle the port used before: torch's own moment sums."""
    u = torch.arange(-TF.HALF_PATCH, TF.HALF_PATCH + 1, dtype=patch.dtype)
    cm = torch.as_tensor(TF._CMASK, dtype=patch.dtype)
    m10 = (patch * (u[None, :] * cm)).sum(dim=(1, 2))
    m01 = (patch * (u[:, None] * cm)).sum(dim=(1, 2))
    ang = torch.atan2(m01, m10) * (180.0 / np.pi)
    ang = torch.where(ang < 0, ang + 360.0, ang)
    return torch.where(valid, ang, torch.zeros_like(ang))


def _print_levels(before):
    with pytest.MonkeyPatch.context() as mp:
        if before:
            mp.setattr(TF, "_blur_valid", _before_blur)
            mp.setattr(TF, "ic_angle_from_patches", _before_angle)
        for frame in (0, 1):
            for lvl, want, got in _levels_compared(frame):
                print(f"frame {frame} level {lvl}: keypoints equal {np.array_equal(want[0], got[0])}, "
                      f"max angle ulp {_ulps(got[3], want[3]).max():.0f}, "
                      f"descriptor rows differing {int((want[4] != got[4]).any(1).sum())} of {len(want[4])}")


def _trees(labels):
    if len(labels) == 1:
        yield labels[0]
        return
    first, rest = labels[0], labels[1:]
    for size in range(len(rest)):
        for comb in itertools.combinations(rest, size):
            for lt in _trees((first,) + comb):
                for rt in _trees(tuple(x for x in rest if x not in comb)):
                    yield (lt, rt)


def _blur_order_search(n_samples=40000):
    """Every binary summation tree of the seven row-pass taps, each node a
    rounded add or a fused multiply-add of a leaf, against XLA's 1 x 7 VALID
    convolution on piecewise-flat rows; prints the best variants."""
    rng = np.random.default_rng(0)
    k = TF._gauss(7, 2.0, torch.float32, "cpu").numpy()
    vals = rng.integers(0, 256, size=(200, 43, 43)).astype(np.float32)
    keep = rng.random((200, 43, 43)) < 0.3
    keep[:, :, 0] = True
    P = np.where(keep, vals, np.nan)
    for c in range(1, 43):  # runs of equal values, as on flat rectangles
        P[:, :, c] = np.where(np.isnan(P[:, :, c]), P[:, :, c - 1], P[:, :, c])
    P = P.astype(np.float32)
    ref = np.asarray(jax.jit(lambda p: jax.lax.conv_general_dilated(
        p[:, None], jnp.asarray(k).reshape(1, 1, 1, 7), (1, 1), "VALID")[:, 0])(jnp.asarray(P))).reshape(-1)
    X = np.stack([P[:, :, i : i + 37] for i in range(7)], -1).reshape(-1, 7)
    idx = rng.permutation(len(ref))[:n_samples]
    X, ref = X[idx], ref[idx]
    prod = [(X[:, i] * k[i]).astype(np.float32) for i in range(7)]

    def fma(i, acc):
        return (X[:, i].astype(np.float64) * np.float64(k[i]) + acc).astype(np.float32)

    def value(tree, choice):
        if isinstance(tree, int):
            return prod[tree]
        a, b = tree
        c = choice.get(id(tree), "add")
        if c == "fa":
            return fma(a, value(b, choice))
        if c == "fb":
            return fma(b, value(a, choice))
        return (value(a, choice) + value(b, choice)).astype(np.float32)

    def nodes(tree):
        return [] if isinstance(tree, int) else [tree] + nodes(tree[0]) + nodes(tree[1])

    results = []
    for tree in _trees(tuple(range(7))):
        ns = nodes(tree)
        opts = [["add"] + (["fa"] if isinstance(n[0], int) else []) + (["fb"] if isinstance(n[1], int) else [])
                for n in ns]
        for combo in itertools.product(*opts):
            bad = int((value(tree, {id(n): c for n, c in zip(ns, combo)}) != ref).sum())
            results.append((bad, repr(tree), combo))
    results.sort(key=lambda r: r[0])
    print(f"blur: {len(results)} variants against {n_samples} outputs; best:")
    for r in results[:4]:
        print("  ", r)


def _moment_order_search():
    """Vector-accumulator schemes for the angle moments (flattening, vector
    width, accumulators, FMA or not, lane reduction) against the jitted
    einsums of JAX's ``ic_angle_from_patches`` on step-scene patches."""
    P = _jax_patches(level=2)[0][:, JF.DESC_R - JF.HALF_PATCH : -(JF.DESC_R - JF.HALF_PATCH),
                                 JF.DESC_R - JF.HALF_PATCH : -(JF.DESC_R - JF.HALF_PATCH)]

    @jax.jit
    def moments(p):
        u = jnp.arange(-JF.HALF_PATCH, JF.HALF_PATCH + 1, dtype=p.dtype)
        c = jnp.asarray(JF._CMASK, dtype=p.dtype)
        return jnp.einsum("nvu,u,vu->n", p, u, c), jnp.einsum("nvu,v,vu->n", p, u, c)

    ref = [np.asarray(m) for m in moments(jnp.asarray(P))]
    u = np.arange(-JF.HALF_PATCH, JF.HALF_PATCH + 1, dtype=np.float32)
    weights = [u[None, :] * JF._CMASK, u[:, None] * JF._CMASK]
    results = []
    for order, vw, nacc, use_fma, red in itertools.product(("vu", "uv"), (4, 8, 16), (1, 2, 4), (0, 1),
                                                           ("halve", "pairs", "serial")):
        bad = 0
        for w, want in zip(weights, ref):
            X = (P if order == "vu" else P.transpose(0, 2, 1)).reshape(len(P), -1).astype(np.float64)
            wf = (w if order == "vu" else w.T).reshape(-1).astype(np.float64)
            step = vw * nacc
            main = (X.shape[1] // step) * step
            acc = np.zeros((len(P), step), np.float32)
            for c in range(0, main, step):
                p = X[:, c : c + step] * wf[c : c + step]
                acc = (p + acc).astype(np.float32) if use_fma else (acc + p.astype(np.float32)).astype(np.float32)
            v = acc[:, :vw]
            for a in range(1, nacc):
                v = (v + acc[:, a * vw : (a + 1) * vw]).astype(np.float32)
            while v.shape[1] > 1:
                if red == "halve":
                    v = (v[:, : v.shape[1] // 2] + v[:, v.shape[1] // 2 :]).astype(np.float32)
                elif red == "pairs":
                    v = (v[:, 0::2] + v[:, 1::2]).astype(np.float32)
                else:
                    v = np.cumsum(v, axis=1, dtype=np.float32)[:, -1:]
            s = v[:, 0]
            for c in range(main, X.shape[1]):
                s = (X[:, c] * wf[c] + s).astype(np.float32) if use_fma else (
                    s + (X[:, c] * wf[c]).astype(np.float32)).astype(np.float32)
            bad += int((s != want).sum())
        results.append((bad, order, vw, nacc, use_fma, red))
    results.sort(key=lambda r: r[0])
    print(f"moments: {len(results)} schemes against {2 * len(P)} sums; best "
          "(differing, flattening, vector width, accumulators, fma, lane reduction):")
    for r in results[:4]:
        print("  ", r)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Stage-0 readings: extract_level on JAX's levels; the order search")
    ap.add_argument("--before", action="store_true", help="with the blur and moment sums used before")
    ap.add_argument("--search", action="store_true", help="run the summation-order searches")
    args = ap.parse_args()
    _print_levels(args.before)
    if args.search:
        _moment_order_search()
        _blur_order_search()
