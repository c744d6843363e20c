"""The port's own copies of the visualisers (viz/) and the map layer
(pipeline/worldmap.py), and their wiring into both pipelines, against the
JAX package's.

Tolerances: the drawing and map code is the same numpy in both packages, so
on identical inputs the PNG and PLY files are byte for byte the same and the
maps hold the same records. Through the pipelines, the frame pictures of
the sequence path are byte for byte JAX's (the two packages' keypoints,
matches and gates agree on the 320 x 320 step scene); the refined points
that the map snapshot, the PLY and ``world_map`` hold come from f32 LM runs
and agree within 1e-5 m (simulation, 60 points) and 1e-4 relative (the
step scene, ~1 m deep: 3.5e-5 measured).
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from test_torch_problems import run_pipeline
from triangulation_in_deformable_scenes_torch.harness import step_scene
from triangulation_in_deformable_scenes_torch.models import deformable as t_def
from triangulation_in_deformable_scenes_torch.pipeline import sequence as t_seq
from triangulation_in_deformable_scenes_torch.pipeline import worldmap as t_wm
from triangulation_in_deformable_scenes_torch.viz import FrameVisualizer as TFrame
from triangulation_in_deformable_scenes_torch.viz import MapVisualizer as TMap
from triangulation_in_deformable_scenes_torch.viz import draw as t_draw
from triangulation_in_deformable_scenes_tpu.config import Config as JConfig
from triangulation_in_deformable_scenes_tpu.models import deformable as j_def
from triangulation_in_deformable_scenes_tpu.pipeline import sequence as j_seq
from triangulation_in_deformable_scenes_tpu.pipeline import worldmap as j_wm
from triangulation_in_deformable_scenes_tpu.viz import FrameVisualizer as JFrame
from triangulation_in_deformable_scenes_tpu.viz import MapVisualizer as JMap
from triangulation_in_deformable_scenes_tpu.viz import draw as j_draw

torch.set_num_threads(1)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("gray", [False, True])
def test_png_roundtrip_byte_identical(tmp_path, gray):
    rng = np.random.default_rng(0)
    im = rng.integers(0, 256, size=(40, 56) if gray else (40, 56, 3), dtype=np.uint8)
    pt, pj = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    t_draw.write_png(pt, im)
    j_draw.write_png(pj, im)
    np.testing.assert_array_equal(t_draw.read_png(pt), im)
    assert _same_bytes(pt, pj)


def test_draw_primitives_equal_jax():
    ims = []
    for d in (t_draw, j_draw):
        im = np.zeros((50, 50, 3), dtype=np.uint8)
        d.draw_circle(im, 25, 25, 5, d.GREEN)
        d.draw_line(im, 0, 0, 49, 49, d.RED)
        assert (im[:, :, 1] > 0).any() and im[0, 0, 0] == 255 and im[49, 49, 0] == 255
        d.draw_circle(im, -10, -10, 3, d.BLUE)  # out of bounds: no raise
        d.draw_line(im, -5, -5, 60, 60, d.BLUE)
        ims.append(im)
    np.testing.assert_array_equal(ims[0], ims[1])


def test_frame_visualizer_outputs_byte_identical(tmp_path):
    im1 = np.full((60, 80), 100, dtype=np.uint8)
    im2 = np.full((60, 80), 50, dtype=np.uint8)
    kp1 = np.array([[10.0, 10.0], [30.0, 20.0], [70.0, 50.0]])
    kp2 = kp1 + 2.0
    outs = []
    for cls, sub in ((TFrame, "t"), (JFrame, "j")):
        fv = cls(enabled=True, out_dir=str(tmp_path / sub))
        paths = [fv.draw_features(kp1, im1)]
        fv.set_reference_frame(kp1, im1)
        paths.append(fv.draw_frame_matches(kp2, im2, np.array([0, 1, -1])))
        paths.append(fv.draw_matches(kp1, im1, kp2, im2, np.array([0, 1, 2])))
        paths.append(fv.draw_triangulated_matches(kp2, im2, np.array([0, 1, 2]), np.array([True, False, True])))
        paths.append(fv.draw_depth_image(np.linspace(0, 1, 60 * 80).reshape(60, 80)))
        outs.append(paths)
    for pt, pj in zip(*outs):
        a = t_draw.read_png(pt)
        assert a.ndim == 3 and a.shape[2] == 3
        assert _same_bytes(pt, pj)
    assert t_draw.read_png(outs[0][1]).shape[1] == 160
    off = TFrame(enabled=False, out_dir=str(tmp_path / "nope"))
    assert off.draw_features(np.zeros((2, 2)), np.zeros((10, 10))) is None
    assert not (tmp_path / "nope").exists()


def test_map_visualizer_snapshot_and_ply_byte_identical(tmp_path):
    rng = np.random.default_rng(1)
    p1 = rng.normal(size=(30, 3)) * 0.1 + [0, 0, 1.0]
    p2 = p1 + 0.01
    poses = [(np.eye(3), np.zeros(3)), (np.eye(3), np.array([0.1, 0, 0]))]
    outs = []
    for cls, sub in ((TMap, "t"), (JMap, "j")):
        mv = cls(enabled=True, out_dir=str(tmp_path / sub), draw_rays=True)
        mv.update(p1, p2, poses)
        outs.append((mv.snapshot(size=200), mv.export_ply()))
    a = t_draw.read_png(outs[0][0])
    assert a.shape == (200, 200, 3)
    assert ((a[:, :, 0] == 255) & (a[:, :, 1] == 0)).any() and (a == 0).all(axis=-1).any()
    txt = open(outs[0][1]).read()
    assert txt.startswith("ply") and f"element vertex {len(p1) + len(p2) + 2}" in txt
    for pt, pj in zip(*outs):
        assert _same_bytes(pt, pj)
    off = TMap(enabled=False, out_dir=str(tmp_path / "off"))
    off.update(np.zeros((1, 3)), np.zeros((1, 3)))
    assert off.snapshot() is None and off.export_ply() is None and not (tmp_path / "off").exists()


def _map_records(m):
    kfs = sorted(m.keyframes)
    return dict(
        n_kf=len(kfs),
        positions=np.stack([m.map_points[i].position for i in sorted(m.map_points)]),
        obs=[sorted(m.kf_obs[k].items()) for k in kfs],
        scales=[m.keyframes[k].depth_scale for k in kfs],
        transform=[np.asarray(x) for x in m.get_global_transform(*kfs)],
    )


def test_build_pair_map_equal_jax():
    """``tests/test_worldmap_ba.py:260`` on both packages' ``build_pair_map``:
    the same keyframes, dual points, observations, scales and transform."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n = 10
    kp = rng.uniform(0, 100, size=(n, 2))
    p1 = rng.normal(size=(n, 3))
    p2 = p1 + 0.01
    valid = np.ones(n, bool)
    valid[3] = False
    Rg, tg = np.eye(3), np.array([0.0, 0.01, 0.0])
    args = ((np.eye(3), np.zeros(3)), (np.eye(3), np.ones(3)), kp, kp, None, None, None, None, p1[:, 2], p2[:, 2])
    mj = j_wm.build_pair_map(*args, j_def.PairState(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(0.5),
                                                     jnp.asarray(1.5), jnp.asarray(Rg), jnp.asarray(tg)), valid)
    mt = t_wm.build_pair_map(*args, t_def.PairState(p1, p2, np.float32(0.5), np.float32(1.5), Rg, tg), valid)
    rj, rt = _map_records(mj), _map_records(mt)
    assert rt["n_kf"] == 2 and len(rt["positions"]) == 2 * (n - 1)
    np.testing.assert_allclose(rt["positions"], rj["positions"], rtol=1e-6)
    assert rt["obs"] == rj["obs"] and rt["scales"] == rj["scales"] == [0.5, 1.5]
    for a, b in zip(rt["transform"], rj["transform"]):
        np.testing.assert_allclose(a, b)
    for k in sorted(mt.keyframes):
        mt.check_keyframe(k)


@pytest.fixture(scope="module")
def sim_runs():
    out = {}
    for pkg in ("jax", "torch"):
        work = tempfile.mkdtemp()
        res, journal = run_pipeline(pkg, 60, 0, 1, 2, 4, work, overrides={"show_scene": True})
        out[pkg] = (res, os.path.join(os.path.dirname(journal), "viz"))
    return out


def test_simulation_writes_the_solution_and_the_map(sim_runs):
    (rj, dj), (rt, dt) = sim_runs["jax"], sim_runs["torch"]
    n_valid = int(rt.valid.sum())
    assert n_valid == int(rj.valid.sum()) == 60
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj)) and any(f.endswith(".png") for f in names)
    png = [f for f in names if f.endswith(".png")][0]
    a = t_draw.read_png(os.path.join(dt, png))
    assert a.shape == t_draw.read_png(os.path.join(dj, png)).shape and (a != 255).any()
    ply = [f for f in names if f.endswith(".ply")][0]
    txt = open(os.path.join(dt, ply)).read()
    assert f"element vertex {2 * n_valid + 2}" in txt
    rec_t, rec_j = _map_records(rt.world_map), _map_records(rj.world_map)
    assert rec_t["n_kf"] == 2 and len(rec_t["positions"]) == 2 * n_valid
    np.testing.assert_allclose(rec_t["positions"], rec_j["positions"], atol=1e-5)
    assert rec_t["obs"] == rec_j["obs"]


def test_sequence_writes_the_frames_the_solution_and_the_map(tmp_path):
    """The 320 x 320 step scene with ``show_scene`` (1 round x 1 evaluation x
    2 LM iterations): the frame pictures byte for byte JAX's, the snapshot
    and the PLY written, the map holding the triangulated pairs."""
    cfg = dataclasses.replace(step_scene.scene_config(step_scene.SMALL, 1, 1, 2), show_scene=True)
    frames = step_scene.step_frames(step_scene.SMALL)
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    oj = j_seq.SequencePipeline(JConfig(**dataclasses.asdict(cfg)), viz_dir=str(dj)).run(
        step_scene.StepSceneLoader(frames), journal_path=str(tmp_path / "j.txt"))
    ot = t_seq.SequencePipeline(cfg, viz_dir=str(dt), device="cpu").run(
        step_scene.StepSceneLoader(frames), journal_path=str(tmp_path / "t.txt"))
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj))
    frame_pngs = [f for f in names if f.endswith(".png") and f.startswith(("features", "matches", "triangulated"))]
    assert len(frame_pngs) >= 4
    for f in frame_pngs:
        assert _same_bytes(dt / f, dj / f), f
    assert any(f.endswith(".ply") for f in names)
    n_tri = ot["init"].n_triangulated
    assert n_tri == oj["init"].n_triangulated
    rec = _map_records(ot["world_map"])
    assert len(rec["positions"]) == n_tri and rec["n_kf"] == 2
    np.testing.assert_allclose(rec["positions"], _map_records(oj["world_map"])["positions"], rtol=1e-4)


@pytest.mark.cuda
def test_simulation_on_card_writes_the_solution_and_the_map(sim_runs, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rj, _ = sim_runs["jax"]
    rc, journal = run_pipeline("torch", 60, 0, 1, 2, 4, str(tmp_path), device="cuda",
                               overrides={"show_scene": True, "show_solution": True})
    vdir = os.path.join(os.path.dirname(journal), "viz")
    png = [f for f in sorted(os.listdir(vdir)) if f.endswith(".png")][0]
    assert (t_draw.read_png(os.path.join(vdir, png)) != 255).any()
    rec_c, rec_j = _map_records(rc.world_map), _map_records(rj.world_map)
    assert len(rec_c["positions"]) == 2 * int(rc.valid.sum()) == len(rec_j["positions"])
    np.testing.assert_allclose(rec_c["positions"], rec_j["positions"], atol=1e-4)
