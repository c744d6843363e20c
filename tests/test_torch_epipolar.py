"""The port's pose-free bootstrap (ops/epipolar.py and the pose-free branch of
``SequencePipeline.initialize_pair``) against the JAX package's.

The rig of ``tests/test_epipolar.py`` (a textured plane, a 12 degree yaw and
a 12 cm baseline) and the 320 x 320 step scene, through both packages on the
CPU in f32. JAX draws its RANSAC samples from ``jax.random``, which torch
cannot reproduce: ``jax_draws`` computes them exactly as
``ransac_essential`` does (``epipolar.py:140-150``) and the port is handed
the same index sets. Tolerances:

- E: up to sign (an SVD fixes its singular vectors only up to sign),
  within 2e-4 entrywise: the 8-point null vector comes from two LAPACK
  builds' f32 SVDs of the same [8, 9] matrix (6.5e-5 measured on the rig);
- the rotations of the decomposition: the same pair (their labels may
  swap, see the port module's docstring), within 1e-5; t up to sign;
- recovered R and t from the same E and inliers: within 1e-5 (1.2e-7
  measured; the sign choices are voted, so they agree); from each
  package's own RANSAC E: within 2e-4 (5.8e-5 measured, E's spread);
- k-means labels, inlier masks and counts: equal;
- the pose-free ``initialize_pair`` with JAX's draws: the same matches,
  triangulated count and validity, parallax within 1e-4 deg.

Run as a script, it prints the spread of the pose-free bootstrap over RANSAC
draws on the full-width step scene (no poses; camera 2 at the baseline
(0.08, 0.01, 0) m): JAX's own draw (key 10) and the port's generator seeds
0-11 on the CPU, each with the rotation's angle from the identity, the
angle between t21 and the true baseline and |t21| against 0.0806 m, the
spread behind ``chip_smoke.py``'s ``POSEFREE_*`` limits:

    JAX_PLATFORMS=cpu python tests/test_torch_epipolar.py
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import tempfile

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_epipolar import make_rig, rot_err_deg
from test_torch_sequence import _jax_config, _small_pair
from triangulation_in_deformable_scenes_torch import convert
from triangulation_in_deformable_scenes_torch.ops import epipolar as t_epi
from triangulation_in_deformable_scenes_torch.ops import matching as t_match
from triangulation_in_deformable_scenes_torch.pipeline import sequence as t_seq
from triangulation_in_deformable_scenes_tpu.ops import epipolar as j_epi
from triangulation_in_deformable_scenes_tpu.ops import features as j_feat
from triangulation_in_deformable_scenes_tpu.ops.matching import essential_from_pose
from triangulation_in_deformable_scenes_tpu.pipeline import sequence as j_seq

torch.set_num_threads(1)


def t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "k_clusters"))
def jax_draws(kp_ref, valid, key, n_hypotheses=17, k_clusters=8):
    """The k-means seeds [k] and the minimal sets [B, k] that JAX's
    ``ransac_essential`` draws from ``key`` (``epipolar.py:99-100, 140-150``)."""
    n = kp_ref.shape[0]
    k_key, s_key = jax.random.split(key)
    vm = valid.astype(jnp.float32)
    init_idx = jax.random.choice(k_key, n, shape=(k_clusters,), replace=False, p=vm / jnp.maximum(jnp.sum(vm), 1.0))
    labels = j_epi._kmeans(kp_ref.astype(jnp.float32), valid, k_clusters, 8, k_key)
    member = (labels[None, :] == jnp.arange(k_clusters)[:, None]) & valid[None, :]
    logits = jnp.where(member, 0.0, -jnp.inf)
    logits = jnp.where(jnp.any(member, axis=1, keepdims=True), logits, jnp.where(valid[None, :], 0.0, -jnp.inf))
    idx = jax.random.categorical(s_key, jnp.broadcast_to(logits, (n_hypotheses, k_clusters, n)), axis=-1)
    return init_idx, idx, labels


def _draws(kp, seed):
    init_idx, idx, labels = jax_draws(jnp.asarray(kp, jnp.float32), jnp.ones(len(kp), bool), jax.random.PRNGKey(seed))
    return torch.as_tensor(np.array(init_idx)), torch.as_tensor(np.array(idx)), np.asarray(labels)


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = 1.0 if np.abs(a - b).max() <= np.abs(a + b).max() else -1.0
    np.testing.assert_allclose(a, s * b, rtol=0, atol=atol)


def test_eight_point_matches_jax():
    kp, rays1, rays2, R21, t21 = make_rig()
    sets = np.stack([np.arange(8), np.arange(8) + 40, np.arange(8) * 20 + 3])
    want = np.asarray(j_epi.compute_essential_8pt(jnp.asarray(rays1[sets], jnp.float32),
                                                  jnp.asarray(rays2[sets], jnp.float32)))
    got = t_epi.compute_essential_8pt(t(rays1[sets]), t(rays2[sets])).numpy()
    for g, w in zip(got, want):
        _same_up_to_sign(g, w, 2e-4)
    inl = t_match.epipolar_inliers(torch.as_tensor(got[0]), t(rays1), t(rays2), 0.01)
    assert float(inl.float().mean()) > 0.95


def test_decompose_essential_matches_jax():
    kp, rays1, rays2, R21, t21 = make_rig()
    E = np.asarray(essential_from_pose(jnp.asarray(R21, jnp.float32), jnp.asarray(t21, jnp.float32)))
    jR1, jR2, jt = (np.asarray(a) for a in j_epi.decompose_essential(jnp.asarray(E)))
    tR1, tR2, tt = (a.numpy() for a in t_epi.decompose_essential(t(E)))
    pairs = [(tR1, jR1), (tR2, jR2)] if np.abs(tR1 - jR1).max() < 1e-3 else [(tR1, jR2), (tR2, jR1)]
    for a, b in pairs:
        np.testing.assert_allclose(a, b, atol=1e-5)
    _same_up_to_sign(tt, jt, 1e-5)
    assert min(rot_err_deg(tR1, R21), rot_err_deg(tR2, R21)) < 0.5
    for R in (tR1, tR2):
        assert abs(np.linalg.det(R) - 1.0) < 1e-5
    # The SVD's sign choice swaps the two rotations and flips t, nothing else.
    U, S, Vt = np.linalg.svd(E.astype(np.float64))
    U[:, 2] *= -1
    Vt[2] *= -1
    fR1, fR2, ft = (a.numpy() for a in t_epi.decompose_essential(t(U @ np.diag(S) @ Vt)))
    assert min(np.abs(fR1 - tR2).max(), np.abs(fR1 - tR1).max()) < 1e-4


def test_reconstruct_cameras_matches_jax():
    kp, rays1, rays2, R21, t21 = make_rig()
    E = essential_from_pose(jnp.asarray(R21, jnp.float32), jnp.asarray(t21, jnp.float32))
    jR, jt = (np.asarray(a) for a in j_epi.reconstruct_cameras(E, jnp.asarray(rays1, jnp.float32),
                                                                jnp.asarray(rays2, jnp.float32)))
    tR, tt = (a.numpy() for a in t_epi.reconstruct_cameras(t(np.asarray(E)), t(rays1), t(rays2)))
    np.testing.assert_allclose(tR, jR, atol=1e-5)
    np.testing.assert_allclose(tt, jt, atol=1e-5)
    assert rot_err_deg(tR, R21) < 1.0
    assert float(np.dot(tt, t21 / np.linalg.norm(t21))) > 0.99
    # Negating E leaves the pose as it was: the vote fixes t's sign.
    nR, nt = (a.numpy() for a in t_epi.reconstruct_cameras(-t(np.asarray(E)), t(rays1), t(rays2)))
    np.testing.assert_allclose(nR, tR, atol=1e-5)
    np.testing.assert_allclose(nt, tt, atol=1e-5)


def test_zero_vote_keeps_the_svds_column_in_both_packages():
    """The degenerate tie: with every ray masked out the vote is 0 and t is
    U[:, 2] as each SVD returned it; both packages' LAPACK SVDs agree."""
    kp, rays1, rays2, R21, t21 = make_rig()
    E = essential_from_pose(jnp.asarray(R21, jnp.float32), jnp.asarray(t21, jnp.float32))
    z = np.zeros_like(rays1, dtype=np.float32)
    _, jt = j_epi.reconstruct_cameras(E, jnp.asarray(z), jnp.asarray(z))
    _, tt = t_epi.reconstruct_cameras(t(np.asarray(E)), t(z), t(z))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_kmeans_labels_match_jax():
    kp, *_ = make_rig(seed=2)
    init_idx, _, labels = _draws(kp, 4)
    got = t_epi._kmeans(t(kp), torch.ones(len(kp), dtype=torch.bool), 8, 8, init_idx=init_idx).numpy()
    np.testing.assert_array_equal(got, labels)


@pytest.mark.parametrize("seed,key", [(0, 0), (3, 1)])
def test_ransac_with_jax_draws_matches_jax(seed, key):
    kp, rays1, rays2, R21, t21 = make_rig(outlier_frac=0.15, seed=seed)
    valid = np.ones(len(kp), bool)
    jE, jinl, jn = j_epi.ransac_essential(jnp.asarray(kp), jnp.asarray(rays1), jnp.asarray(rays2),
                                          jnp.asarray(valid), jax.random.PRNGKey(key), epipolar_th=0.005)
    init_idx, idx, _ = _draws(kp, key)
    tE, tinl, tn = t_epi.ransac_essential(t(kp), t(rays1), t(rays2), torch.as_tensor(valid), epipolar_th=0.005,
                                          init_idx=init_idx, sample_idx=idx)
    _same_up_to_sign(tE.numpy(), np.asarray(jE), 2e-4)
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) > 120
    w = jnp.asarray(jinl, jnp.float32)[:, None]
    jR0, jt0 = j_epi.reconstruct_cameras(jE, jnp.asarray(rays1, jnp.float32) * w, jnp.asarray(rays2, jnp.float32) * w)
    tw = tinl.float()[:, None]
    tR0, tt0 = t_epi.reconstruct_cameras(torch.as_tensor(np.asarray(jE)), t(rays1) * tw, t(rays2) * tw)
    np.testing.assert_allclose(tR0.numpy(), np.asarray(jR0), atol=1e-5)
    np.testing.assert_allclose(tt0.numpy(), np.asarray(jt0), atol=1e-5)

    jR, jt, jinl2, _ = j_epi.initialize_pose_free(jnp.asarray(kp), jnp.asarray(rays1), jnp.asarray(rays2),
                                                  jnp.asarray(valid), jax.random.PRNGKey(key), epipolar_th=0.005)
    tR, tt, tinl2, _ = t_epi.initialize_pose_free(t(kp), t(rays1), t(rays2), torch.as_tensor(valid),
                                                  epipolar_th=0.005, init_idx=init_idx, sample_idx=idx)
    np.testing.assert_array_equal(tinl2.numpy(), np.asarray(jinl2))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=2e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-4)


def test_ransac_with_its_own_generator_recovers_the_pose():
    """The port's own draws (a seeded generator): the pose within 1 degree,
    t's direction and sign, and the same result for the same seed."""
    kp, rays1, rays2, R21, t21 = make_rig(outlier_frac=0.15)
    args = (t(kp), t(rays1), t(rays2), torch.ones(len(kp), dtype=torch.bool))
    R, tt, inl, n = t_epi.initialize_pose_free(*args, torch.Generator().manual_seed(10), epipolar_th=0.005)
    assert int(n) > 120
    assert rot_err_deg(R.numpy(), R21) < 1.0
    assert float(np.dot(tt.numpy(), t21 / np.linalg.norm(t21))) > 0.99
    R2, t2, inl2, _ = t_epi.initialize_pose_free(*args, torch.Generator().manual_seed(10), epipolar_th=0.005)
    assert torch.equal(R, R2) and torch.equal(tt, t2) and torch.equal(inl, inl2)


def _with_draws(monkeypatch, init_idx, sample_idx):
    """Make the port's pose-free bootstrap use these RANSAC draws."""
    monkeypatch.setattr(t_epi, "initialize_pose_free",
                        functools.partial(t_epi.initialize_pose_free, init_idx=init_idx, sample_idx=sample_idx))


def test_pose_free_initialize_pair_matches_jax(monkeypatch):
    """The 320 x 320 step scene's JAX keypoints, no poses: JAX's pipeline with
    its key 10 and the port handed the same draws."""
    frames, cfg, kps = _small_pair()
    jpipe = j_seq.SequencePipeline(_jax_config(cfg), viz_dir=tempfile.mkdtemp())
    jk = [j_feat.Keypoints(**{k: jnp.asarray(v) for k, v in kp.items()}) for kp in kps]
    want = jpipe.initialize_pair(jk[0], jk[1], None, None, frames[0][1], frames[1][1])
    assert want.accepted and want.T2w_est is not None

    init_idx, idx, _ = _draws(want.kp1, 10)
    tpipe = t_seq.SequencePipeline(cfg, device="cpu")
    tk = [convert.keypoints_from_numpy(kp, device="cpu") for kp in kps]
    with monkeypatch.context() as m:
        _with_draws(m, init_idx, idx)
        got = tpipe.initialize_pair(tk[0], tk[1], None, None, frames[0][1], frames[1][1])
    assert got.accepted
    assert got.n_matches == want.n_matches
    np.testing.assert_array_equal(got.kp1, want.kp1)
    assert got.n_triangulated == want.n_triangulated
    np.testing.assert_array_equal(got.valid, want.valid)
    assert abs(got.parallax_deg - want.parallax_deg) < 1e-4
    for a, b in zip(got.T2w_est, want.T2w_est):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    # The pose-free run's own draws (the generator seeded with 10) on the same
    # keypoints: a pose within 2 degrees of the scene's identity rotation.
    own = tpipe.initialize_pair(tk[0], tk[1], None, None, frames[0][1], frames[1][1])
    assert own.accepted
    assert rot_err_deg(own.T2w_est[0].numpy(), np.eye(3)) < 2.0


@pytest.mark.cuda
def test_ransac_on_card_with_jax_draws():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    kp, rays1, rays2, R21, t21 = make_rig(outlier_frac=0.15)
    init_idx, idx, _ = _draws(kp, 0)
    valid = torch.ones(len(kp), dtype=torch.bool)
    cpu = t_epi.initialize_pose_free(t(kp), t(rays1), t(rays2), valid, epipolar_th=0.005, init_idx=init_idx,
                                     sample_idx=idx)
    card = t_epi.initialize_pose_free(t(kp).cuda(), t(rays1).cuda(), t(rays2).cuda(), valid.cuda(),
                                      epipolar_th=0.005, init_idx=init_idx.cuda(), sample_idx=idx.cuda())
    np.testing.assert_array_equal(card[2].cpu().numpy(), cpu[2].numpy())
    np.testing.assert_allclose(card[0].cpu().numpy(), cpu[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(card[1].cpu().numpy(), cpu[1].numpy(), atol=1e-4)
    R, tt, _, _ = t_epi.initialize_pose_free(t(kp).cuda(), t(rays1).cuda(), t(rays2).cuda(), valid.cuda(),
                                             torch.Generator(device="cuda").manual_seed(10), epipolar_th=0.005)
    assert rot_err_deg(R.cpu().numpy(), R21) < 1.0


@pytest.mark.cuda
def test_pose_free_initialize_pair_on_card(monkeypatch):
    """The pose-free branch on the card with JAX's draws: the CPU's matches,
    count and validity; its own draws: a pose within 2 degrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    frames, cfg, kps = _small_pair()
    cpu = t_seq.SequencePipeline(cfg, device="cpu")
    card = t_seq.SequencePipeline(cfg, device="cuda")
    tk = [convert.keypoints_from_numpy(kp, device="cpu") for kp in kps]
    ck = [convert.keypoints_from_numpy(kp, device="cuda") for kp in kps]
    want = cpu.initialize_pair(tk[0], tk[1], None, None, frames[0][1], frames[1][1])
    init_idx, idx, _ = _draws(want.kp1, 10)
    with monkeypatch.context() as m:
        _with_draws(m, init_idx, idx)
        want = cpu.initialize_pair(tk[0], tk[1], None, None, frames[0][1], frames[1][1])
    with monkeypatch.context() as m:
        _with_draws(m, init_idx.cuda(), idx.cuda())
        got = card.initialize_pair(ck[0], ck[1], None, None, frames[0][1], frames[1][1])
    assert got.n_matches == want.n_matches and got.n_triangulated == want.n_triangulated
    np.testing.assert_array_equal(got.valid, want.valid)
    own = card.initialize_pair(ck[0], ck[1], None, None, frames[0][1], frames[1][1])
    assert own.accepted and rot_err_deg(own.T2w_est[0].cpu().numpy(), np.eye(3)) < 2.0


def _pose_errors(R, t, t_true):
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    tdir = np.degrees(np.arccos(np.clip(t @ t_true / (np.linalg.norm(t) * np.linalg.norm(t_true)), -1.0, 1.0)))
    return rot_err_deg(R, np.eye(3)), float(tdir), float(np.linalg.norm(t))


def _main():
    from triangulation_in_deformable_scenes_torch.harness import step_scene
    from triangulation_in_deformable_scenes_tpu.config import Config as JConfig

    cfg = step_scene.scene_config(step_scene.FULL, 1, 1, 2)
    frames = step_scene.step_frames(step_scene.FULL)
    t_true = -np.asarray(frames[1][2][1], np.float64) + np.asarray(frames[0][2][1], np.float64)
    print(f"truth: |t21| = {np.linalg.norm(t_true):.5f} m")
    jpipe = j_seq.SequencePipeline(JConfig(**dataclasses.asdict(cfg)), viz_dir=tempfile.mkdtemp())
    jk = [jpipe.extract(j_seq.to_grayscale(f[0])) for f in frames]
    r = jpipe.initialize_pair(jk[0], jk[1], None, None, frames[0][1], frames[1][1])
    rot, tdir, norm = _pose_errors(*r.T2w_est, t_true)
    print(f"jax key 10: matches {r.n_matches} map points {r.n_triangulated} R21 {rot:.3f} deg "
          f"t21 direction {tdir:.2f} deg |t21| {norm:.5f} m")
    tpipe = t_seq.SequencePipeline(cfg, device="cpu")
    tk = [tpipe.extract(t_seq.to_grayscale(f[0])) for f in frames]
    draw = t_epi.initialize_pose_free
    for seed in range(12):
        def seeded(*args, **kwargs):
            return draw(*args[:4], torch.Generator().manual_seed(seed), *args[5:], **kwargs)

        t_epi.initialize_pose_free = seeded
        try:
            r = tpipe.initialize_pair(tk[0], tk[1], None, None, frames[0][1], frames[1][1])
        finally:
            t_epi.initialize_pose_free = draw
        rot, tdir, norm = _pose_errors(*(x.numpy() for x in r.T2w_est), t_true)
        print(f"port seed {seed}: matches {r.n_matches} map points {r.n_triangulated} R21 {rot:.3f} deg "
              f"t21 direction {tdir:.2f} deg |t21| {norm:.5f} m")


if __name__ == "__main__":
    _main()
