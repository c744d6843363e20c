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
- angles 1e-3 deg (the moment sums on resampled levels round in other orders;
  ~1e-4 measured);
- the patch blur 1e-4 (a seven-slice sum against XLA's convolution);
- descriptors from identical patches and angles: at most 0.5 % of bits
  differ (cos/sin of the angle may differ by an ulp and move a tap at .5,
  the tolerance tests/test_features.py:151-182 allows between two JAX
  formulations);
- ``extract`` on the 320 x 320 step scene: level-0 keypoints identical, 99 %
  of all keypoints identical, 99.5 % of descriptor bits equal on the shared
  keypoints (resampling differences flip ties of taps in flat regions on the
  upper levels: ~0.3 % measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triangulation_in_deformable_scenes_torch.harness import step_scene
from triangulation_in_deformable_scenes_torch.ops import features as TF
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


def test_orb_descriptors_from_jax_patches():
    P, ang, ok = _jax_patches()
    Pb = JF.blur_patches(jnp.asarray(P))
    want = np.asarray(JF.orb_descriptors_from_patches(Pb, jnp.asarray(ang), jnp.asarray(ok)))
    got = TF.orb_descriptors_from_patches(t(np.asarray(Pb)), t(ang), t(ok)).numpy()
    assert got.dtype == np.uint8 and got.shape == (len(ok), 256)
    assert (got != want).mean() <= 0.005


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
