"""Synthetic two-camera simulation pipeline on the card.

Counterpart of ``triangulation_in_deformable_scenes_tpu/pipeline/simulation.py``
(the reference's ``Execution/simulation.cc``), with the same steps and
journal blocks:

1. load ground-truth point pairs from csv;
2. camera 1 at ``c1_pose`` with identity rotation, camera 2 at ``c2_pose``
   looking at the first moved point (``simulation.py:77-82``);
3. pixel observations proj(GT) + N(0, sigma_px), rounded, and depths
   z * scale + N(0, sigma_d), noise from numpy ``default_rng(seed)``
   (``:84-104``);
4. KB8 unprojection and dual-point triangulation with parallax gating
   (``:106-125``);
5. initial depth scales mean(d/z) with their standard errors (``:127-141``);
6. the outer refinement (``models/outer.py``);
7. the Experiment.txt journal.

Device work is f32 on ``device`` (default ``cuda``; ``device="cpu"`` must be
asked for). After the refinement, as in JAX (``:257-281``), the headless map
visualiser writes a PNG snapshot and a PLY of the refined dual points when
``show_scene`` or ``show_solution`` is set, and the map layer
(``pipeline/worldmap.py``) builds ``SimulationResult.world_map``; both are
numpy code that gets host copies of the device tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models import deformable, outer
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops import triangulation as tri
from ..precision import FP
from ..utils import csvio, metrics as metrics_mod
from ..utils.journal import ExperimentJournal
from ..viz import MapVisualizer
from .worldmap import build_pair_map


@dataclasses.dataclass
class SimulationResult:
    state: deformable.PairState
    valid: np.ndarray
    initial: metrics_mod.AbsoluteErrors
    final: metrics_mod.AbsoluteErrors
    initial_pix: metrics_mod.PixelsError
    final_pix: metrics_mod.PixelsError
    weights: np.ndarray
    rounds: int
    n_matches: int
    n_map_points: int
    parallax_deg: float
    world_map: object = None
    rigid_accepted: bool = False
    stats: outer.SolveStats = None


class SimulationPipeline:
    def __init__(self, cfg: Config, seed: int = 0, mesh_backend: str = "auto", device="cuda"):
        self.cfg = cfg
        self.seed = seed
        self.mesh_backend = mesh_backend
        self.device = resolve_device(device)
        self.cam_kind = cam_ops.KB8
        self.cam_params = cfg.kb8_params

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=FP, device=self.device)

    def _poses(self, moved0):
        c1 = self._t(self.cfg.c1_pose)
        c2 = self._t(self.cfg.c2_pose)
        T1w = (torch.eye(3, dtype=FP, device=self.device), c1)
        T2w = (lie.look_at(c2, self._t(moved0)), c2)
        return T1w, T2w

    def _simulate_observations(self, orig, moved, T1w, T2w, rng):
        """Noisy pixels + corrupted depths (``simulation.py:84-104``)."""
        cfg = self.cfg
        params = self._t(self.cam_params)
        p1c = lie.apply(*T1w, self._t(orig))
        p2c = lie.apply(*T2w, self._t(moved))
        kp1 = cam_ops.project(self.cam_kind, params, p1c).cpu().numpy()
        kp2 = cam_ops.project(self.cam_kind, params, p2c).cpu().numpy()
        kp1 = kp1 + rng.normal(scale=max(cfg.sim_rep_error, 1e-300), size=kp1.shape)
        kp2 = kp2 + rng.normal(scale=max(cfg.sim_rep_error, 1e-300), size=kp2.shape)
        kp1 = np.round(kp1, cfg.decimals_rep_error)
        kp2 = np.round(kp2, cfg.decimals_rep_error)

        sigma_d = cfg.sim_depth_error / 1000.0
        d1 = p1c.cpu().numpy()[:, 2] * cfg.sim_depth_scale_c1 + rng.normal(
            scale=max(sigma_d, 1e-300), size=len(orig)
        )
        d2 = p2c.cpu().numpy()[:, 2] * cfg.sim_depth_scale_c2 + rng.normal(
            scale=max(sigma_d, 1e-300), size=len(orig)
        )
        return kp1, kp2, d1, d2

    def _triangulate(self, kp1, kp2, T1w, T2w, d1, d2):
        """``Mapping::triangulateSimulatedMapPoints`` (``simulation.py:106-125``)."""
        cfg = self.cfg
        params = self._t(self.cam_params)
        xn1 = cam_ops.unproject(self.cam_kind, params, self._t(kp1))
        xn2 = cam_ops.unproject(self.cam_kind, params, self._t(kp2))
        xn1 = xn1 / torch.linalg.norm(xn1, dim=-1, keepdim=True)
        xn2 = xn2 / torch.linalg.norm(xn2, dim=-1, keepdim=True)
        if cfg.triangulation_method == tri.DEPTH:
            xn1 = xn1 / xn1[:, 2:3] * self._t(d1)[:, None]
            xn2 = xn2 / xn2[:, 2:3] * self._t(d2)[:, None]
        x1, x2 = tri.triangulate(
            xn1, xn2, T1w, T2w, method=cfg.triangulation_method, location=cfg.triangulation_location
        )
        valid = tri.valid_parallax_mask(xn1, xn2, T1w, T2w, x1, x2, cfg.min_cos)
        return x1, x2, valid.cpu().numpy(), xn1, xn2

    @staticmethod
    def _initial_depth_scale(p, T, d, valid):
        """s0 = mean(d/z) and its standard error (``simulation.py:127-141``)."""
        z = lie.apply(T[0], T[1], p).cpu().numpy()[:, 2]
        v = np.asarray(valid, dtype=bool) & (np.asarray(d) != 0)
        ratios = np.asarray(d)[v] / z[v]
        se = float(ratios.std() / max(np.sqrt(len(ratios)), 1.0))
        return float(ratios.mean()), se

    def run(
        self,
        original_file: str,
        moved_file: str,
        journal_path: Optional[str] = None,
        echo: bool = False,
    ) -> SimulationResult:
        cfg = self.cfg
        dev = self.device
        rng = np.random.default_rng(self.seed)
        orig, moved = csvio.load_point_pairs(original_file, moved_file)
        T1w, T2w = self._poses(moved[0])

        kp1, kp2, d1, d2 = self._simulate_observations(orig, moved, T1w, T2w, rng)
        p1, p2, valid, xn1, xn2 = self._triangulate(kp1, kp2, T1w, T2w, d1, d2)
        n_valid = int(valid.sum())

        # ARAP_OneSet protocol: set 1 anchored at the ground truth (``:160-169``).
        spec = deformable.MODELS.get(cfg.opt_model, deformable.ModelSpec())
        if spec.one_set:
            p1 = self._t(orig)

        s1, se1 = self._initial_depth_scale(p1, T1w, d1, valid)
        s2, se2 = self._initial_depth_scale(p2, T2w, d2, valid)
        scale_priors = (s1, 1.0 / max(se1, 1e-6) ** 2, s2, 1.0 / max(se2, 1e-6) ** 2)

        state = deformable.PairState(
            p1=p1,
            p2=p2,
            s1=self._t(s1),
            s2=self._t(s2),
            Rg=torch.eye(3, dtype=FP, device=dev),
            tg=torch.zeros(3, dtype=FP, device=dev),
        )

        journal = ExperimentJournal(journal_path or cfg.exp_file_path, echo=echo)
        baseline = float(np.linalg.norm(T2w[1].cpu().numpy() - T1w[1].cpu().numpy()))
        parallax = metrics_mod.mean_parallax_degrees(xn1, xn2, T1w, T2w, valid)
        journal.header(baseline, parallax, len(orig), 2 * n_valid)

        gt_index = np.arange(len(orig))

        def measure(state):
            pix = metrics_mod.pixels_stand_dev(
                self.cam_kind, self.cam_params, T1w, T2w, state.p1, state.p2, kp1, kp2, valid,
                device=dev,
            )
            rel = metrics_mod.relative_map_errors(
                T1w, T2w, state.p1, state.p2, float(state.s1), float(state.s2), d1, d2, valid,
                state.Rg, state.tg, device=dev,
            )
            abs_err = metrics_mod.sim_absolute_errors(state.p1, state.p2, valid, gt_index, orig, moved)
            return pix, rel, abs_err

        pix0, rel0, abs0 = measure(state)
        journal.block_header("INITIAL MEASUREMENTS:")
        journal.relative(pix0, rel0)
        journal.sim_absolute(abs0)

        # Depth-uncertainty quirk fallback (``simulation.py:208-209``).
        ocfg = outer.outer_config(cfg)

        def on_round(i, state_i, weights_i):
            journal.block_header(f"{i} / {ocfg.n_optimizations} MEASUREMENTS:")
            pix, rel, abs_err = measure(state_i)
            journal.relative(pix, rel)
            journal.sim_absolute(abs_err)

        result = outer.deformation_optimization(
            self.cam_kind,
            self.cam_params,
            T1w,
            T2w,
            kp1,
            kp2,
            d1,
            d2,
            valid,
            state,
            ocfg,
            on_round=on_round,
            mesh_backend=self.mesh_backend,
            scale_priors=scale_priors,
        )

        journal.block_header("FINAL MEASUREMENTS:")
        pix1, rel1, abs1 = measure(result.state)
        journal.relative(pix1, rel1)
        journal.sim_absolute(abs1)

        host = deformable.PairState(*(x.cpu().numpy() for x in result.state))
        T1h = tuple(x.cpu().numpy() for x in T1w)
        T2h = tuple(x.cpu().numpy() for x in T2w)
        # Solution visualisation, headless PNG + PLY (``simulation.py:257-272``).
        if cfg.show_scene or cfg.show_solution:
            out_dir = os.path.join(os.path.dirname(os.path.abspath(journal_path or cfg.exp_file_path)), "viz")
            mviz = MapVisualizer(enabled=True, out_dir=out_dir, draw_rays=cfg.draw_rays)
            mviz.update(host.p1[valid], host.p2[valid], [(R.T, -R.T @ t) for R, t in (T1h, T2h)])
            mviz.snapshot()
            mviz.export_ply()

        # Map-layer insertion: dual points per match, observations, the
        # refined global SE3 (``simulation.py:274-281``).
        wmap = build_pair_map(
            T1h, T2h, kp1, kp2, None, None, None, None, d1, d2, host, valid,
            scale_factor=cfg.scale_factor, n_scales=cfg.n_scales,
        )

        return SimulationResult(
            state=result.state,
            valid=valid,
            initial=abs0,
            final=abs1,
            initial_pix=pix0,
            final_pix=pix1,
            weights=result.weights,
            rounds=result.rounds,
            n_matches=len(orig),
            n_map_points=2 * n_valid,
            parallax_deg=parallax,
            world_map=wmap,
            rigid_accepted=result.rigid_accepted,
            stats=result.stats,
        )
