"""Image-sequence pipeline on the card: Drunkard / RealColon / Syncolon two-view mapping.

Counterpart of ``triangulation_in_deformable_scenes_tpu/pipeline/sequence.py``
(the reference's ``Execution/drunkard.cc:80-101`` + ``SLAM::processImage`` +
``Mapping::monocularMapInitialization``), with the same steps:

frame loop -> grayscale (green channel for 4-channel endoscopy frames) ->
masked FAST+ORB extraction (``ops/features.py``) -> windowed Hamming matching
against the reference frame (``ops/matching.py``; on the card the top-2 scan
is the hand-written kernel 3) -> optional epipolar filter with E from the
known poses -> dual-point triangulation with depth-limit / reprojection /
parallax gates -> per-keyframe depth-scale estimate -> the deformation-
regularised refinement (``models/outer.py``, whose dense solves are kernel 1)
-> the Experiment.txt journal. The loop stops at the first pair that
triangulates, like the reference mains.

Device work is f32 on ``device`` (default ``cuda``; ``device="cpu"`` must be
asked for); the gates, depth lookups and metrics are host numpy, as in JAX.
Without poses (a loader that yields ``pose = None``) the pair's pose comes
from the pose-free bootstrap (``ops/epipolar.py``: cluster-sampled RANSAC
over batched 8-point hypotheses, its draws from a generator seeded with 10
on the device; JAX's ``jax.random`` draws cannot be reproduced, so the two
packages sample different hypotheses) with |t| from the depth sensor. The
headless visualisers (``show_scene`` / ``show_solution``) and the map layer
(``pipeline/worldmap.py``, ``world_map`` in the result) are numpy code fed
with host copies, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models import deformable, outer
from ..ops import camera as cam_ops
from ..ops import epipolar as epi_ops
from ..ops import features as feat_ops
from ..ops import lie
from ..ops import matching as match_ops
from ..ops import triangulation as tri
from ..precision import FP
from ..utils import metrics as metrics_mod
from ..utils.journal import ExperimentJournal
from ..viz import FrameVisualizer, MapVisualizer
from .worldmap import build_pair_map


def to_grayscale(im: np.ndarray) -> np.ndarray:
    """``SLAM::convertImageToGrayScale``: 3ch -> RGB2GRAY weights on the
    BGR-loaded buffer (reference quirk kept), 4ch -> green channel."""
    if im.ndim == 2:
        return im.astype(np.float32)
    if im.shape[2] == 4:
        return im[:, :, 1].astype(np.float32)
    b, g, r = im[:, :, 0], im[:, :, 1], im[:, :, 2]
    # cv::COLOR_RGB2GRAY applied to a BGR buffer weights blue as red.
    return (0.299 * b + 0.587 * g + 0.114 * r).astype(np.float32)


@dataclasses.dataclass
class PairInitResult:
    accepted: bool
    reason: str = ""
    n_matches: int = 0
    n_triangulated: int = 0
    parallax_deg: float = 0.0
    # arrays over the match list (compact):
    kp1: np.ndarray = None
    kp2: np.ndarray = None
    p1: np.ndarray = None
    p2: np.ndarray = None
    valid: np.ndarray = None
    octave1: np.ndarray = None
    octave2: np.ndarray = None
    d1: np.ndarray = None
    d2: np.ndarray = None
    s1: float = 1.0
    s2: float = 1.0
    # Pose-free mode: the recovered world-to-camera poses (None when the
    # loader's poses were used).
    T1w_est: tuple = None
    T2w_est: tuple = None
    # Depth-scale prior (s1_0, info1, s2_0, info2) from the estimate's SE.
    scale_priors: tuple = None


class SequencePipeline:
    def __init__(self, cfg: Config, border_mask: Optional[np.ndarray] = None, viz_dir: str = "./viz",
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cam_kind = cam_ops.KB8
        self.cam_params = cfg.kb8_params
        self.border_mask = border_mask
        self.scale_factors = np.array([cfg.scale_factor**o for o in range(cfg.n_scales)])
        # Headless visualisers, gated like the reference's showScene flags
        # (``sequence.py:96-100``); numpy code fed with host copies.
        self.frame_viz = FrameVisualizer(enabled=cfg.show_scene, out_dir=viz_dir)
        self.map_viz = MapVisualizer(enabled=cfg.show_scene or cfg.show_solution, out_dir=viz_dir,
                                     draw_rays=cfg.draw_rays)

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=FP, device=self.device)

    # ------------------------------------------------------------------
    def extract(self, gray: np.ndarray) -> feat_ops.Keypoints:
        kps = feat_ops.extract(
            gray,
            n_features=self.cfg.n_features,
            n_scales=self.cfg.n_scales,
            scale_factor=self.cfg.scale_factor,
            border_mask=self.border_mask,
            device=self.device,
        )
        if self.cfg.distortion:
            # Radial-tangential keypoint undistortion (Frame::undistortKeys,
            # Frame.cc:252-277): matching and geometry use the undistorted
            # positions, like the reference's vKeys_.
            und = cam_ops.undistort_points(self._t(self.cfg.pinhole_params), tuple(self.cfg.distortion), kps.xy)
            kps = kps._replace(xy=und)
        return kps

    @staticmethod
    def depth_at(depth_im: np.ndarray, kp: np.ndarray) -> np.ndarray:
        """Measured depth at pixel locations: bilinear / 100 (Frame.cc:112-116)."""
        return metrics_mod.bilinear_interpolate(depth_im, kp[:, 0], kp[:, 1]) / 100.0

    # ------------------------------------------------------------------
    def initialize_pair(
        self,
        k_ref: feat_ops.Keypoints,
        k_cur: feat_ops.Keypoints,
        T1w,
        T2w,
        depth_ref: np.ndarray,
        depth_cur: np.ndarray,
    ) -> PairInitResult:
        """Match, triangulate and gate one frame pair. With ``T2w`` None the
        pose comes from the pose-free bootstrap, whose RANSAC draws come
        from a generator seeded with 10 on the pipeline's device
        (``ops/epipolar.py``)."""
        cfg = self.cfg
        matches, n_matches = match_ops.search_for_initialization(
            k_ref.xy,
            k_ref.desc,
            k_ref.octave,
            k_ref.valid,
            k_cur.xy,
            k_cur.desc,
            k_cur.octave,
            k_cur.valid,
            scale_factors=self._t(self.scale_factors),
            th=float(cfg.matching_init_th),
            window_factor=float(cfg.matching_init_radius),
        )
        n_matches = int(n_matches)
        if n_matches < cfg.min_matches:
            return PairInitResult(False, "not enough matches", n_matches)

        m = matches.cpu().numpy()
        ridx = np.nonzero(m >= 0)[0]
        cidx = m[ridx]
        kp1 = k_ref.xy.cpu().numpy()[ridx]
        kp2 = k_cur.xy.cpu().numpy()[cidx]
        oct1 = k_ref.octave.cpu().numpy()[ridx]
        oct2 = k_cur.octave.cpu().numpy()[cidx]

        params = self._t(self.cam_params)
        xn1 = cam_ops.unproject(self.cam_kind, params, self._t(kp1))
        xn2 = cam_ops.unproject(self.cam_kind, params, self._t(kp2))
        xn1 = xn1 / torch.linalg.norm(xn1, dim=-1, keepdim=True)
        xn2 = xn2 / torch.linalg.norm(xn2, dim=-1, keepdim=True)

        inliers = np.ones(len(kp1), dtype=bool)
        T1w_est = T2w_est = None
        if T2w is None:
            # Pose-free bootstrap (``sequence.py:173-210``): cluster-sampled
            # RANSAC over batched 8-point hypotheses recovers T21 up to the
            # monocular scale; the depth sensor then fixes |t|.
            if T1w is None:
                T1w = (torch.eye(3, dtype=FP, device=self.device), torch.zeros(3, dtype=FP, device=self.device))
            # A zero Epipolar.th (unset in some yamls) would zero the
            # consensus: 0.01 rad then, as in JAX.
            epi_th = float(cfg.epipolar_th) if cfg.epipolar_th > 0 else 0.01
            gen = torch.Generator(device=self.device).manual_seed(10)
            R21, t21, inl, _ = epi_ops.initialize_pose_free(
                self._t(kp1), xn1, xn2, torch.ones(len(kp1), dtype=torch.bool, device=self.device), gen,
                epipolar_th=epi_th,
            )
            # |t| = median(d / z_prov) over a unit-baseline triangulation,
            # when at least 8 points qualify.
            x1p, _ = tri.triangulate(xn1, xn2, T1w, lie.compose(R21, t21, *T1w), method=tri.NRSLAM)
            z_prov = lie.apply(*T1w, x1p)[:, 2].cpu().numpy()
            d_prov = self.depth_at(depth_ref, kp1)
            inl = inl.cpu().numpy()
            ok = inl & (z_prov > 0) & (d_prov > 0)
            if ok.sum() >= 8:
                t21 = t21 * float(np.median(d_prov[ok] / z_prov[ok]))
            T2w = lie.compose(R21, t21, *T1w)
            inliers &= inl
            T1w_est, T2w_est = T1w, T2w
        if cfg.checks:
            # Epipolar filter with E from the KNOWN relative pose
            # (MonocularMapInitializer.cc:119-178 computes E from the pose).
            R12, t12 = lie.compose(*T1w, *lie.inverse(*T2w))
            E = match_ops.essential_from_pose(R12, t12)
            inliers = match_ops.epipolar_inliers(E, xn1, xn2, cfg.epipolar_th).cpu().numpy()

        x1, x2 = tri.triangulate(
            xn1, xn2, T1w, T2w, method=cfg.triangulation_method, location=cfg.triangulation_location
        )
        x1, x2 = x1.cpu().numpy(), x2.cpu().numpy()
        R1, t1 = T1w[0].cpu().numpy(), T1w[1].cpu().numpy()
        R2, t2 = T2w[0].cpu().numpy(), T2w[1].cpu().numpy()

        # Gates (reconstructPoints, MonocularMapInitializer.cc:281-395).
        finite = np.isfinite(x1).all(-1) & np.isfinite(x2).all(-1)
        nonzero = (np.abs(x1).sum(-1) > 0) & (np.abs(x2).sum(-1) > 0)
        z1 = (x1 @ R1.T + t1)[:, 2]
        z2 = (x2 @ R2.T + t2)[:, 2]
        depth_limit = cfg.depth_limit if cfg.depth_limit > 0 else np.inf
        depth_ok = (z1 >= 0) & (z1 <= depth_limit) & (z2 >= 0) & (z2 <= depth_limit)
        valid = inliers & finite & nonzero & depth_ok

        if cfg.checks:
            proj1 = cam_ops.project(self.cam_kind, params, self._t(x1 @ R1.T + t1)).cpu().numpy()
            proj2 = cam_ops.project(self.cam_kind, params, self._t(x2 @ R2.T + t2)).cpu().numpy()
            chi1 = ((proj1 - kp1) ** 2).sum(-1)
            chi2 = ((proj2 - kp2) ** 2).sum(-1)
            valid &= (chi1 <= 5.991) & (chi2 <= 5.991)

        # Depth-measurement gates from the mapping layer (Mapping.cc:191-200).
        d1 = self.depth_at(depth_ref, kp1)
        d2 = self.depth_at(depth_cur, kp2)
        valid &= (d1 > 0) & (d2 > 0)
        # Reference quirk kept verbatim: the fixed (0.1, 1500) px box
        # regardless of the image size (Mapping.cc:197-199).
        valid &= (kp1 > 0.1).all(-1) & (kp1 < 1500).all(-1)
        valid &= (kp2 > 0.1).all(-1) & (kp2 < 1500).all(-1)

        n_tri = int(valid.sum())
        if n_tri == 0:
            return PairInitResult(False, "no triangulated points", n_matches)

        # Parallax statistic: 50th smallest cosine (largest angles),
        # reconstructPoints (MonocularMapInitializer.cc:374-395).
        ray1 = xn1.cpu().numpy() @ R1
        ray2 = xn2.cpu().numpy() @ R2
        cosp = (ray1 * ray2).sum(-1) / (np.linalg.norm(ray1, axis=-1) * np.linalg.norm(ray2, axis=-1))
        cos_sorted = np.sort(cosp[valid])
        idx = min(50, len(cos_sorted) - 1)
        parallax_deg = float(np.degrees(np.arccos(np.clip(cos_sorted[idx], -1, 1))))

        if not (n_tri * 2 >= 25 and parallax_deg > cfg.min_cos):
            return PairInitResult(False, "parallax/points gate", n_matches, 2 * n_tri, parallax_deg)

        # Depth-scale estimation over sufficiently-parallaxed points
        # (Mapping.cc:211-254).
        deg = np.degrees(np.arccos(np.clip(cosp, -1, 1)))
        sel = valid & (deg > cfg.min_cos)
        if sel.sum() == 0:
            sel = valid
        r1 = d1[sel] / z1[sel]
        r2 = d2[sel] / z2[sel]
        s1, s2 = float(r1.mean()), float(r2.mean())
        # Standard error of the scale estimate -> depth-scale prior info.
        n_sel = max(len(r1), 1)
        se1 = max(float(r1.std()) / np.sqrt(n_sel), 1e-6)
        se2 = max(float(r2.std()) / np.sqrt(n_sel), 1e-6)
        scale_priors = (s1, 1.0 / se1**2, s2, 1.0 / se2**2)

        return PairInitResult(
            True,
            "ok",
            n_matches,
            2 * n_tri,
            parallax_deg,
            kp1=kp1,
            kp2=kp2,
            p1=x1,
            p2=x2,
            valid=valid,
            octave1=oct1,
            octave2=oct2,
            d1=d1,
            d2=d2,
            s1=s1,
            s2=s2,
            T1w_est=T1w_est,
            T2w_est=T2w_est,
            scale_priors=scale_priors,
        )

    # ------------------------------------------------------------------
    def run(
        self,
        loader,
        start: int = 0,
        end: Optional[int] = None,
        step: int = 1,
        journal_path: Optional[str] = None,
        mesh_backend: str = "auto",
    ):
        """Frame loop; stops after the first triangulated pair (ref mains)."""
        ref = ref_pose = ref_depth = ref_gray = None
        for _, rgb, depth, pose, _ in loader.frames(start, end, step):
            gray = to_grayscale(rgb)
            kps = self.extract(gray)
            if self.frame_viz.enabled:
                self.frame_viz.draw_features(kps.xy.cpu().numpy(), gray, kps.valid.cpu().numpy(), name="features")
            # Loaders without trajectory ground truth yield pose None: the
            # pose-free bootstrap recovers it.
            Tcw = None
            if pose is not None and pose[0] is not None:
                Tcw = lie.inverse(self._t(pose[0]), self._t(pose[1]))
            if ref is None:
                ref, ref_pose, ref_depth, ref_gray = kps, Tcw, depth, gray
                self._set_reference_frame(kps, gray)
                continue

            init = self.initialize_pair(ref, kps, ref_pose, Tcw, ref_depth, depth)
            if not init.accepted:
                if init.n_matches < self.cfg.min_matches:
                    ref, ref_pose, ref_depth, ref_gray = kps, Tcw, depth, gray
                    self._set_reference_frame(kps, gray)
                continue

            if self.frame_viz.enabled:
                # The match list is compact: pair i of kp1 is pair i of kp2.
                pairing = np.arange(len(init.kp1))
                self.frame_viz.draw_matches(init.kp1, ref_gray, init.kp2, gray, pairing, name="matches")
                self.frame_viz.draw_triangulated_matches(init.kp2, gray, pairing, init.valid, name="triangulated")

            T1w_use = init.T1w_est if init.T1w_est is not None else ref_pose
            T2w_use = init.T2w_est if init.T2w_est is not None else Tcw
            return self._refine_and_report(init, T1w_use, T2w_use, journal_path, mesh_backend)
        return None

    def _set_reference_frame(self, kps, gray):
        if self.frame_viz.enabled:
            self.frame_viz.set_reference_frame(kps.xy.cpu().numpy(), gray)

    def _refine_and_report(self, init: PairInitResult, T1w, T2w, journal_path, mesh_backend):
        cfg = self.cfg
        dev = self.device
        state = deformable.PairState(
            p1=self._t(init.p1),
            p2=self._t(init.p2),
            s1=self._t(init.s1),
            s2=self._t(init.s2),
            Rg=torch.eye(3, dtype=FP, device=dev),
            tg=torch.zeros(3, dtype=FP, device=dev),
        )

        journal = ExperimentJournal(journal_path or cfg.exp_file_path)
        t1 = lie.inverse(*T1w)[1].cpu().numpy()
        t2 = lie.inverse(*T2w)[1].cpu().numpy()
        journal.header(float(np.linalg.norm(t2 - t1)), init.parallax_deg, init.n_matches, init.n_triangulated)

        def measure(st):
            pix = metrics_mod.pixels_stand_dev(
                self.cam_kind, self.cam_params, T1w, T2w, st.p1, st.p2, init.kp1, init.kp2, init.valid,
                device=dev,
            )
            rel = metrics_mod.relative_map_errors(
                T1w, T2w, st.p1, st.p2, float(st.s1), float(st.s2), init.d1, init.d2,
                init.valid, st.Rg, st.tg, device=dev,
            )
            abs_err = metrics_mod.real_absolute_errors(
                cfg.pinhole_params, T1w, T2w, st.p1, st.p2, init.kp1, init.kp2, init.d1, init.d2, init.valid,
            )
            return pix, rel, abs_err

        pix0, rel0, abs0 = measure(state)
        journal.block_header("INITIAL MEASUREMENTS:")
        journal.relative(pix0, rel0)
        journal.real_absolute(abs0)

        ocfg = outer.outer_config(cfg)

        def on_round(i, st, w):
            journal.block_header(f"{i} / {ocfg.n_optimizations} MEASUREMENTS:")
            pix, rel, abs_err = measure(st)
            journal.relative(pix, rel)
            journal.real_absolute(abs_err)

        result = outer.deformation_optimization(
            self.cam_kind,
            self.cam_params,
            T1w,
            T2w,
            init.kp1,
            init.kp2,
            init.d1,
            init.d2,
            init.valid,
            state,
            ocfg,
            on_round=on_round,
            mesh_backend=mesh_backend,
            scale_priors=init.scale_priors,
        )

        journal.block_header("FINAL MEASUREMENTS:")
        pix1, rel1, abs1 = measure(result.state)
        journal.relative(pix1, rel1)
        journal.real_absolute(abs1)

        host = deformable.PairState(*(x.cpu().numpy() for x in result.state))
        T1h = tuple(x.cpu().numpy() for x in T1w)
        T2h = tuple(x.cpu().numpy() for x in T2w)
        if self.map_viz.enabled:
            v = np.asarray(init.valid, dtype=bool)
            self.map_viz.update(host.p1[v], host.p2[v], [(R.T, -R.T @ t) for R, t in (T1h, T2h)])
            self.map_viz.snapshot()
            self.map_viz.export_ply()

        # Map-layer insertion: dual points per match with observations and
        # the refined global SE3 (``sequence.py:484-490``).
        wmap = build_pair_map(
            T1h, T2h, init.kp1, init.kp2, None, None, init.octave1, init.octave2,
            init.d1, init.d2, host, init.valid,
            scale_factor=cfg.scale_factor, n_scales=cfg.n_scales,
        )

        return {
            "init": init,
            "state": result.state,
            "weights": result.weights,
            "initial": abs0,
            "final": abs1,
            "initial_pix": pix0,
            "final_pix": pix1,
            "world_map": wmap,
            "rounds": result.rounds,
            "stats": result.stats,
        }
