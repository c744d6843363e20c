"""Parity of the port's bundle adjustment (``models/bundle_adjustment.py``)
with the JAX package, on the CPU, on the scenes of tests/test_worldmap_ba.py
(``harness/ba_scene.py`` builds them as numpy arrays, handed to both).

Limits: the assembled (H, g) within 1e-4 of JAX's largest entry (f32 sums of
hundreds of [9, 9] blocks in another order); after an LM run the cost within
1e-4 relative and the points within 1e-6 m; the pose-only inlier mask and
local BA's (n_edges, n_removed) and culled set equal (its poses and
points are free along the scale gauge; see that test). The full-BA scene carries 0.5 px of
pixel noise, so that the cost converges to a positive floor and a relative
limit means something (without noise both packages drive it to rounding
noise, where no relative limit holds).

Run as a script, it prints the JAX package's CPU values of the card's BA
scene (8 keyframes x 1,000 points) that ``chip_smoke.py`` holds the port to:

    JAX_PLATFORMS=cpu python tests/test_torch_bundle_adjustment.py [--port]

(``--port``: the port's CPU values beside them, a few minutes.)
"""

import os
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_worldmap_ba as jax_ba_tests
from triangulation_in_deformable_scenes_torch import convert
from triangulation_in_deformable_scenes_torch.harness import ba_scene
from triangulation_in_deformable_scenes_torch.models import bundle_adjustment as t_ba
from triangulation_in_deformable_scenes_torch.ops import damped_cholesky as dc
from triangulation_in_deformable_scenes_tpu.models import bundle_adjustment as j_ba
from triangulation_in_deformable_scenes_tpu.pipeline import worldmap as j_wm

torch.set_num_threads(1)

# The card's scene: 8 keyframes x 1,000 points (dim 3,048, 8,000
# observations), 0.5 px of noise, the first two poses fixed; pose-only on
# 1,000 points with 50 gross outliers.
CARD_SCENE = dict(n_pts=1000, n_kf=8, noise_px=0.5)
CARD_OUTLIERS = 50


def jax_ba(data, state):
    d = j_ba.BAData(**{k: jnp.asarray(v) for k, v in data.items()})
    d = d._replace(obs_kf=d.obs_kf.astype(jnp.int32), obs_mp=d.obs_mp.astype(jnp.int32))
    return d, j_ba.BAState(**{k: jnp.asarray(v, jnp.float32) for k, v in state.items()})


def torch_ba(data, state):
    return convert.ba_data_from_numpy(data, device="cpu"), convert.ba_state_from_numpy(state, device="cpu")


def rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("robust", [True, False])
def test_build_system_matches_jax(robust):
    """(H, g) at the perturbed state within 1e-4 of the largest entry of JAX's."""
    data, state, _ = ba_scene.ba_problem(n_pts=40, n_kf=3, noise_px=0.5)
    jd, js = jax_ba(data, state)
    td, ts = torch_ba(data, state)
    Hj, gj = j_ba._build_system("KB8", jd, js, robust)
    Ht, gt = t_ba._build_system("KB8", td, ts, robust)
    assert rel_max(Ht, Hj) < 1e-4
    assert rel_max(gt, gj) < 1e-4
    # Fixed poses have no rows: keyframes 0 and 1 hold the first 12 columns.
    assert float(Ht[:12].abs().max()) == 0.0
    assert float(t_ba._cost("KB8", td, ts, robust)) == pytest.approx(float(j_ba._cost("KB8", jd, js, robust)), rel=1e-5)


def test_bundle_adjustment_matches_jax():
    """Full BA, 20 iterations: the same n_accepted, the cost within 1e-4
    relative and the points within 1e-6 m of JAX's; the fixed poses do not
    move; the points end nearer the truth than they started."""
    data, state, pts = ba_scene.ba_problem(n_pts=40, n_kf=3, noise_px=0.5)
    jd, js = jax_ba(data, state)
    td, ts = torch_ba(data, state)
    rj = j_ba.bundle_adjustment("KB8", jd, js, n_iterations=20)
    rt = t_ba.bundle_adjustment("KB8", td, ts, n_iterations=20)
    assert rt.n_accepted == int(rj.n_accepted)
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * float(rj.cost)
    np.testing.assert_allclose(rt.state.points.numpy(), np.asarray(rj.state.points), atol=1e-6)
    assert torch.equal(rt.state.R[:2], ts.R[:2]) and torch.equal(rt.state.t[:2], ts.t[:2])
    err = np.linalg.norm(rt.state.points.numpy() - pts, axis=-1).mean()
    assert err < np.linalg.norm(state["points"] - pts, axis=-1).mean()


def test_pose_only_matches_jax():
    """Pose-only with 5 gross outliers: JAX's inlier mask, and the pose
    within 1e-5 of JAX's and of the truth (the JAX test's limit)."""
    pts, uv, R0, t0, R, t = ba_scene.pose_only_problem()
    Rt, tt, mt = t_ba.pose_only_optimization("KB8", ba_scene.CAM, pts, uv, np.ones(len(pts)), R0, t0, device="cpu")
    Rj, tj, mj = j_ba.pose_only_optimization("KB8", ba_scene.CAM, pts, uv, np.ones(len(pts)), R0, t0)
    np.testing.assert_array_equal(mt, np.asarray(mj))
    assert not mt[:5].any() and mt[5:].all()
    for got, want in ((Rt, Rj), (tt, tj), (Rt, R), (tt, t)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def _map_chi2(wm):
    """Sum of the squared reprojection errors (pixels^2) of every
    observation left in ``wm``, in f64: invariant under the scale gauge."""
    cam = torch.as_tensor(ba_scene.CAM)
    total = 0.0
    for k, kf in wm.keyframes.items():
        for m, i in wm.kf_obs[k].items():
            pc = torch.as_tensor(np.asarray(kf.R_cw, np.float64) @ wm.map_points[m].position + kf.t_cw)
            e = kf.kp[i] - t_ba.cam_ops.project("KB8", cam, pc).numpy()
            total += float(e @ e)
    return total


def test_local_bundle_adjustment_matches_jax():
    """Local BA on the 3-keyframe map with one corrupted observation
    (test_local_bundle_adjustment_runs_and_culls): the same (n_edges,
    n_removed) and the same culled observations. Only keyframe 0 is fixed
    here, so the solution is free along the monocular scale gauge
    (tests/test_worldmap_ba.py:118-120): H is singular along it, the damped
    steps there follow each package's rounding, and poses and points part
    along it (8e-5 m read), so they are not compared. The summed squared
    reprojection error of the observations left, which the gauge does not
    change, is held within 1e-3 relative (4.1e-4 read: after 10 iterations
    the two runs stand at different points of the flat valley's floor)."""
    pts, poses, obs = ba_scene.make_scene(noise_px=0.2)
    wt, ids_t = ba_scene.make_map(pts, poses, [o.copy() for o in obs])
    wj, ids_j = jax_ba_tests.make_map(pts, poses, [o.copy() for o in obs])
    assert isinstance(wj, j_wm.WorldMap)
    for wm in (wt, wj):
        wm.keyframes[1].kp[0] += 50.0
    got = t_ba.local_bundle_adjustment(wt, 1, "KB8", ba_scene.CAM, n_iterations=10, device="cpu")
    want = j_ba.local_bundle_adjustment(wj, 1, "KB8", ba_scene.CAM, n_iterations=10)
    assert got == want and got[0] == 3 * len(pts) and got[1] >= 1
    assert wt.is_map_point_in_keyframe(ids_t[0], 1) == wj.is_map_point_in_keyframe(ids_j[0], 1) == -1
    assert {k: sorted(v.values()) for k, v in wt.kf_obs.items()} == {k: sorted(v.values()) for k, v in wj.kf_obs.items()}
    assert _map_chi2(wt) == pytest.approx(_map_chi2(wj), rel=1e-3)


def test_ba_state_converts_from_numpy():
    data, state, _ = ba_scene.ba_problem(n_pts=6, n_kf=2)
    td, ts = torch_ba(data, state)
    assert td.obs_kf.dtype == torch.int64 and td.obs_valid.dtype == torch.bool and td.fixed_pose.dtype == torch.bool
    assert td.obs_uv.dtype == torch.float32 and ts.R.shape == (2, 3, 3)
    np.testing.assert_array_equal(td.obs_mp.numpy(), data["obs_mp"])


def test_scene_matches_the_jax_tests_construction():
    """harness/ba_scene draws tests/test_worldmap_ba.py's scene: the same
    points, poses and observations to f32 precision."""
    pts, poses, obs = ba_scene.make_scene(n_pts=40, n_kf=3, noise_px=0.2)
    pj, posj, obsj = jax_ba_tests.make_scene(n_pts=40, n_kf=3, noise_px=0.2)
    np.testing.assert_array_equal(pts, pj)
    for (R, t), (Rj, tj), uv, uvj in zip(poses, posj, obs, obsj):
        np.testing.assert_allclose(R, Rj, atol=1e-6)
        np.testing.assert_array_equal(t, tj)
        np.testing.assert_allclose(uv, uvj, atol=1e-3)


def test_pose_only_without_device_raises_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    pts, uv, R0, t0, _, _ = ba_scene.pose_only_problem(n_pts=8, n_outliers=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ba.pose_only_optimization("KB8", ba_scene.CAM, pts, uv, np.ones(8), R0, t0)


@pytest.mark.cuda
def test_cuda_bundle_adjustment_repeats_bit_identical():
    """On the card: kernel-1 launches equal the damped solves, and two runs
    give the same bits (H is J^T J, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    data, state, _ = ba_scene.ba_problem(n_pts=200, n_kf=4, noise_px=0.5)
    td, ts = convert.ba_data_from_numpy(data), convert.ba_state_from_numpy(state)
    before = dc.LAUNCHES
    r1 = t_ba.bundle_adjustment("KB8", td, ts)
    assert dc.LAUNCHES - before == r1.n_solves
    r2 = t_ba.bundle_adjustment("KB8", td, ts)
    assert torch.equal(r1.cost, r2.cost) and all(torch.equal(a, b) for a, b in zip(r1.state, r2.state))


def _main(argv):
    port = "--port" in argv
    data, state, pts = ba_scene.ba_problem(**CARD_SCENE)
    jd, js = jax_ba(data, state)
    rj = j_ba.bundle_adjustment("KB8", jd, js, n_iterations=20)
    err = np.linalg.norm(np.asarray(rj.state.points, np.float64) - pts, axis=-1).mean()
    print(f"JAX_BA_INITIAL_COST = {float(rj.initial_cost)!r}")
    print(f"JAX_BA_FINAL_COST = {float(rj.cost)!r}")
    print(f"JAX_BA_N_ACCEPTED = {int(rj.n_accepted)!r}")
    print(f"JAX_BA_MEAN_POINT_ERROR_M = {float(err)!r}")
    if port:
        rt = t_ba.bundle_adjustment("KB8", *torch_ba(data, state), n_iterations=20)
        err_t = np.linalg.norm(rt.state.points.numpy().astype(np.float64) - pts, axis=-1).mean()
        print(f"# port CPU: cost {float(rt.cost)!r} ({abs(float(rt.cost) / float(rj.cost) - 1):.3e} from JAX), "
              f"n_accepted {rt.n_accepted}, mean point error {err_t!r} ({abs(err_t / err - 1):.3e}), "
              f"max point difference {np.abs(rt.state.points.numpy() - np.asarray(rj.state.points)).max():.3e} m")
    n = CARD_SCENE["n_pts"]
    p, uv, R0, t0, _, _ = ba_scene.pose_only_problem(n_pts=n, n_outliers=CARD_OUTLIERS)
    Rj, tj, mj = j_ba.pose_only_optimization("KB8", ba_scene.CAM, p, uv, np.ones(n), R0, t0)
    print(f"JAX_POSE_ONLY_OUTLIERS = {np.nonzero(~np.asarray(mj))[0].tolist()!r}")
    print(f"JAX_POSE_ONLY_R = {np.asarray(Rj, np.float64).tolist()!r}")
    print(f"JAX_POSE_ONLY_T = {np.asarray(tj, np.float64).tolist()!r}")
    if port:
        Rt, tt, mt = t_ba.pose_only_optimization("KB8", ba_scene.CAM, p, uv, np.ones(n), R0, t0, device="cpu")
        print(f"# port CPU: mask equal {np.array_equal(mt, np.asarray(mj))}, R {np.abs(Rt - Rj).max():.3e}, "
              f"t {np.abs(tt - tj).max():.3e} from JAX")
    sc_pts, poses, obs = ba_scene.make_scene(CARD_SCENE["n_pts"], CARD_SCENE["n_kf"], noise_px=CARD_SCENE["noise_px"])
    wj, _ = jax_ba_tests.make_map(sc_pts, poses, [o.copy() for o in obs])
    wj.keyframes[1].kp[0] += 50.0
    print(f"JAX_LOCAL_BA = {j_ba.local_bundle_adjustment(wj, 1, 'KB8', ba_scene.CAM, n_iterations=10)!r}")
    if port:
        wt, _ = ba_scene.make_map(sc_pts, poses, [o.copy() for o in obs])
        wt.keyframes[1].kp[0] += 50.0
        print(f"# port CPU local BA: {t_ba.local_bundle_adjustment(wt, 1, 'KB8', ba_scene.CAM, n_iterations=10, device='cpu')!r}")


if __name__ == "__main__":
    _main(sys.argv[1:])
