"""The port's image-sequence path (pipeline/sequence.py) against the JAX package's.

Same frames (``harness/step_scene.py``, numpy from a seed) and settings
through both packages on the CPU. Tolerances:

- ``undistort_points``: 1e-4 px (the same f32 ops; XLA may fuse them);
- ``bilinear_interpolate``, ``real_absolute_errors``, ``to_grayscale``: the
  same numpy arithmetic, so equal (the errors to 1e-12 relative);
- ``initialize_pair`` on identical keypoints (the JAX package's, handed over
  by ``convert.keypoints_from_numpy``): the same matches, triangulated count
  and validity; parallax within 1e-4 deg; d1, d2, s1, s2 within 1e-6
  relative (unprojection and triangulation are f32 on both sides);
- the whole pipeline on the 320 x 320 step scene, reduced budget (1 round x
  3 evaluations x 5 LM iterations), each package extracting its own
  keypoints: matches and triangulated points within 5 %, parallax within
  0.05 deg, initial and final mean 3D error within 3 % (before the port
  took XLA's blur and moment orders: 85 / 84 matches, errors 0.23 % / 0.76 %
  apart; the descriptors now agree, see ``test_torch_features.py``).

Run as a script, it prints the values that ``chip_smoke.py`` holds the port
to: the full-width step scene (1024 x 1024, 1000 features, 8 scales, pair
preset ``1024_00000_1229-1236``) through the JAX package on the CPU, or with
``--port`` through the port on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_sequence.py --rounds 5 --evals 8 --iters 25 [--port]
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import pytest
import torch

from triangulation_in_deformable_scenes_torch import convert
from triangulation_in_deformable_scenes_torch.harness import step_scene
from triangulation_in_deformable_scenes_torch.ops import camera as t_cam
from triangulation_in_deformable_scenes_torch.ops import lie as t_lie
from triangulation_in_deformable_scenes_torch.ops import matching as t_match
from triangulation_in_deformable_scenes_torch.pipeline import sequence as t_seq
from triangulation_in_deformable_scenes_torch.utils import metrics as t_metrics
from triangulation_in_deformable_scenes_tpu.config import Config as JConfig
from triangulation_in_deformable_scenes_tpu.ops import camera as j_cam
from triangulation_in_deformable_scenes_tpu.ops import features as j_feat
from triangulation_in_deformable_scenes_tpu.ops import lie as j_lie
from triangulation_in_deformable_scenes_tpu.ops import matching as j_match
from triangulation_in_deformable_scenes_tpu.pipeline import sequence as j_seq
from triangulation_in_deformable_scenes_tpu.utils import metrics as j_metrics

torch.set_num_threads(1)


def _jax_config(cfg):
    return JConfig(**dataclasses.asdict(cfg))


def test_undistort_points_matches_jax():
    rng = np.random.default_rng(0)
    pix = rng.uniform(0, 640, size=(200, 2)).astype(np.float32)
    params = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    dist = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.01)
    want = np.asarray(j_cam.undistort_points(jnp.asarray(params), dist, jnp.asarray(pix)))
    got = t_cam.undistort_points(torch.as_tensor(params), dist, torch.as_tensor(pix)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got - pix).max() > 1.0  # the distortion is not negligible


def test_bilinear_interpolate_matches_jax():
    rng = np.random.default_rng(1)
    im = rng.uniform(0, 300, size=(40, 50)).astype(np.float32)
    x = rng.uniform(-2, 52, size=300)
    y = rng.uniform(-2, 42, size=300)
    np.testing.assert_array_equal(t_metrics.bilinear_interpolate(im, x, y), j_metrics.bilinear_interpolate(im, x, y))


def test_real_absolute_errors_matches_jax():
    rng = np.random.default_rng(2)
    n = 60
    p1 = (rng.normal(size=(n, 3)) * [0.2, 0.2, 0.05] + [0, 0, 1.0]).astype(np.float32)
    p2 = (p1 + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)
    kp1 = rng.uniform(0, 320, size=(n, 2)).astype(np.float32)
    kp2 = rng.uniform(0, 320, size=(n, 2)).astype(np.float32)
    d1 = rng.uniform(0.8, 1.2, n)
    d2 = rng.uniform(0.8, 1.2, n)
    valid = rng.uniform(size=n) > 0.2
    T1 = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    T2 = (np.eye(3, dtype=np.float32), np.array([-0.1, 0.0, 0.01], np.float32))
    ph = np.array([190.68, 190.68, 160.0, 160.0])
    want = j_metrics.real_absolute_errors(ph, tuple(map(jnp.asarray, T1)), tuple(map(jnp.asarray, T2)),
                                          p1, p2, kp1, kp2, d1, d2, valid)
    got = t_metrics.real_absolute_errors(ph, tuple(map(torch.as_tensor, T1)), tuple(map(torch.as_tensor, T2)),
                                         torch.as_tensor(p1), torch.as_tensor(p2), kp1, kp2, d1, d2, valid)
    for f in ("av_movement", "av_error", "rmse", "av_up_to_scale"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, err_msg=f)


def test_to_grayscale_matches_jax():
    rng = np.random.default_rng(3)
    for shape in ((20, 30), (20, 30, 3), (20, 30, 4)):
        im = rng.integers(0, 256, size=shape).astype(np.uint8)
        np.testing.assert_array_equal(t_seq.to_grayscale(im), j_seq.to_grayscale(im))


def test_loaders_read_a_drunkard_folder(tmp_path):
    """The port's own loader copy reads a Drunkard-layout folder written with
    cv2 exactly as the JAX package's loader does."""
    cv2 = pytest.importorskip("cv2")
    from triangulation_in_deformable_scenes_torch.datasets import DrunkardLoader as TLoader
    from triangulation_in_deformable_scenes_tpu.datasets import DrunkardLoader as JLoader

    (tmp_path / "color").mkdir()
    (tmp_path / "depth").mkdir()
    lines = []
    for i, (rgb, depth, (R, t)) in enumerate(step_scene.step_frames(step_scene.SMALL)):
        cv2.imwrite(str(tmp_path / "color" / f"{i}.png"), rgb)
        cv2.imwrite(str(tmp_path / "depth" / f"{i}.png"), depth.astype(np.uint16))
        lines.append(f"{i} {t[0]} {t[1]} {t[2]} 0 0 0 1\n")
    (tmp_path / "pose.txt").write_text("".join(lines))
    tl = TLoader(str(tmp_path), str(tmp_path / "pose.txt"))
    jl = JLoader(str(tmp_path), str(tmp_path / "pose.txt"))
    assert len(tl) == len(jl) == 2
    got, want = list(tl.frames()), list(jl.frames())
    frames = step_scene.step_frames(step_scene.SMALL)
    for g, w, f in zip(got, want, frames):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[2], f[1])  # the quantised depth round-trips
        np.testing.assert_array_equal(g[3][0], w[3][0])
        np.testing.assert_array_equal(g[3][1], w[3][1])
        assert g[2].dtype == np.float32


def _small_pair():
    """The 320 x 320 step scene's frames, its config and the JAX package's
    keypoints of both frames (as numpy arrays)."""
    frames = step_scene.step_frames(step_scene.SMALL)
    cfg = step_scene.scene_config(step_scene.SMALL)
    kps = [j_feat.extract(j_seq.to_grayscale(f[0]), cfg.n_features, cfg.n_scales, cfg.scale_factor)
           for f in frames]
    return frames, cfg, [{k: np.asarray(v) for k, v in kp._asdict().items()} for kp in kps]


@pytest.mark.parametrize("checks", [False, True])
def test_initialize_pair_on_identical_keypoints(checks):
    """Also with the reference's checks: the epipolar filter with E from the
    known poses and the reprojection chi^2 gate."""
    frames, cfg, kps = _small_pair()
    cfg = dataclasses.replace(cfg, checks=checks, epipolar_th=0.01)
    jpipe = j_seq.SequencePipeline(_jax_config(cfg), viz_dir=tempfile.mkdtemp())
    jT = [j_lie.inverse(jnp.asarray(f[2][0]), jnp.asarray(f[2][1])) for f in frames]
    jk = [j_feat.Keypoints(**{k: jnp.asarray(v) for k, v in kp.items()}) for kp in kps]
    want = jpipe.initialize_pair(jk[0], jk[1], jT[0], jT[1], frames[0][1], frames[1][1])

    tpipe = t_seq.SequencePipeline(cfg, device="cpu")
    tT = [t_lie.inverse(torch.as_tensor(f[2][0], dtype=torch.float32), torch.as_tensor(f[2][1], dtype=torch.float32))
          for f in frames]
    tk = [convert.keypoints_from_numpy(kp, device="cpu") for kp in kps]
    got = tpipe.initialize_pair(tk[0], tk[1], tT[0], tT[1], frames[0][1], frames[1][1])

    assert want.accepted and got.accepted
    assert got.n_matches == want.n_matches > 50
    np.testing.assert_array_equal(got.kp1, want.kp1)
    np.testing.assert_array_equal(got.kp2, want.kp2)
    np.testing.assert_array_equal(got.octave1, want.octave1)
    assert got.n_triangulated == want.n_triangulated
    np.testing.assert_array_equal(got.valid, want.valid)
    assert abs(got.parallax_deg - want.parallax_deg) < 1e-4
    for f in ("d1", "d2"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6, err_msg=f)
    for f in ("s1", "s2"):
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-6 * abs(getattr(want, f)), f

    m_j, _ = j_match.search_for_initialization(
        jk[0].xy, jk[0].desc, jk[0].octave, jk[0].valid, jk[1].xy, jk[1].desc, jk[1].octave, jk[1].valid,
        jnp.asarray(jpipe.scale_factors), th=float(cfg.matching_init_th), window_factor=float(cfg.matching_init_radius))
    m_t, _ = t_match.search_for_initialization(
        tk[0].xy, tk[0].desc, tk[0].octave, tk[0].valid, tk[1].xy, tk[1].desc, tk[1].octave, tk[1].valid,
        torch.as_tensor(tpipe.scale_factors), th=float(cfg.matching_init_th),
        window_factor=float(cfg.matching_init_radius))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def run_scene(package, scene, rounds, evals, iters):
    """The step scene through one package's ``SequencePipeline`` on the CPU;
    returns the values chip_smoke.py holds the port to."""
    cfg = step_scene.scene_config(scene, rounds, evals, iters)
    frames = step_scene.step_frames(scene)
    tmp = tempfile.mkdtemp()
    if package == "jax":
        pipe = j_seq.SequencePipeline(_jax_config(cfg), viz_dir=tmp)
        n_valid = [int(np.asarray(j_feat.extract(j_seq.to_grayscale(f[0]), cfg.n_features, cfg.n_scales,
                                                 cfg.scale_factor).valid).sum()) for f in frames]
    else:
        pipe = t_seq.SequencePipeline(cfg, device="cpu")
        n_valid = [int(pipe.extract(t_seq.to_grayscale(f[0])).valid.sum()) for f in frames]
    out = pipe.run(step_scene.StepSceneLoader(frames), journal_path=os.path.join(tmp, "Experiment.txt"))
    init = out["init"]
    return dict(n_valid=n_valid, n_matches=init.n_matches, n_triangulated=init.n_triangulated,
                parallax_deg=init.parallax_deg, initial_av_error_m=out["initial"].av_error,
                final_av_error_m=out["final"].av_error, weights=np.asarray(out["weights"]).tolist())


def test_sequence_pipeline_matches_jax():
    want = run_scene("jax", step_scene.SMALL, 1, 3, 5)
    got = run_scene("torch", step_scene.SMALL, 1, 3, 5)
    assert got["n_valid"] == want["n_valid"]
    for k in ("n_matches", "n_triangulated"):
        assert abs(got[k] - want[k]) <= 0.05 * want[k], (k, got[k], want[k])
    assert abs(got["parallax_deg"] - want["parallax_deg"]) < 0.05
    for k in ("initial_av_error_m", "final_av_error_m"):
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 0.03 * want[k], (k, got[k], want[k])


def _main(argv):
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description="Sequence-path reference values on the full-width step scene")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--evals", type=int, default=8)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--port", action="store_true", help="run the port on the CPU instead of the JAX package")
    ap.add_argument("--small", action="store_true", help="the 320 x 320 scene instead of the full-width one")
    args = ap.parse_args(argv)
    t0 = time.time()
    vals = run_scene("torch" if args.port else "jax", step_scene.SMALL if args.small else step_scene.FULL,
                     args.rounds, args.evals, args.iters)
    vals["package"] = "port (cpu)" if args.port else "jax (cpu)"
    vals["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(vals))


if __name__ == "__main__":
    _main(sys.argv[1:])
