"""World map: keyframe/landmark registries, observation + covisibility graphs.

Rebuilds the reference's L2 domain model (``Modules/Map/Map.{h,cc}``,
``KeyFrame``, ``MapPoint``) in array-first form: keyframes store their
per-feature arrays (keypoints, octaves, descriptors as [N, 256] bit rows,
depths) and the map keeps id registries plus the kf<->landmark observation
graph and the covisibility counts (``Map.cc:100-176``). Host-side dicts do
the bookkeeping -- they are orchestration state, exactly the role the
reference's single-process ``Map`` object plays -- while every numeric
update (normals, best-descriptor medians, scale-invariance ranges) runs
batched (``Map::updateOrientationAndDescriptor``, ``Map.cc:270-321``).

``clone`` is O(1)-cheap compared with the reference's deep copy
(``Map.cc:30-58``): positions live in immutable arrays, so a clone shares
them and only copies the dict spines (the outer weight search in the
reference clones the whole map per evaluation precisely because its state is
mutable).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

import numpy as np


@dataclasses.dataclass
class KeyFrameData:
    """Frozen per-keyframe arrays (the reference's ``KeyFrame``)."""

    kf_id: int
    R_cw: np.ndarray  # world-to-camera
    t_cw: np.ndarray
    kp: np.ndarray  # [N, 2] pixels (undistorted)
    octave: np.ndarray  # [N]
    desc: np.ndarray  # [N, 256] 0/1 bits
    depth: Optional[np.ndarray] = None  # [N] measured depths
    depth_scale: float = 1.0  # estimated depth scale (KeyFrame.cc:131-153)
    scale_factor: float = 1.2
    n_scales: int = 8

    @property
    def center(self) -> np.ndarray:
        """Camera center in world coordinates."""
        return -self.R_cw.T @ self.t_cw

    def scene_median_depth(self, positions: np.ndarray) -> float:
        """Median camera-frame depth over the given world points
        (``KeyFrame::computeSceneMedianDepth``, KeyFrame.cc:231-244;
        nth_element semantics: the size//2-th order statistic)."""
        z = (np.asarray(positions) @ self.R_cw.T + self.t_cw)[:, 2]
        if len(z) == 0:
            return 0.0
        return float(np.partition(z, len(z) // 2)[len(z) // 2])


@dataclasses.dataclass
class MapPointData:
    """The reference's ``MapPoint``: position + appearance statistics."""

    mp_id: int
    position: np.ndarray  # [3] world
    normal: Optional[np.ndarray] = None
    descriptor: Optional[np.ndarray] = None  # [256] bits
    min_distance_invariance: float = 0.0
    max_distance_invariance: float = np.inf


class WorldMap:
    def __init__(self, min_common_obs: int = 0):
        self.min_common_obs = min_common_obs
        self.keyframes: Dict[int, KeyFrameData] = {}
        self.map_points: Dict[int, MapPointData] = {}
        # kf_id -> {mp_id: feature index} and the transpose.
        self.kf_obs: Dict[int, Dict[int, int]] = {}
        self.mp_obs: Dict[int, Dict[int, int]] = {}
        self.covisibility: Dict[int, Dict[int, int]] = {}
        # (kf1, kf2) -> (R, t) global alignment store (Map.cc:323-343).
        self.global_transforms: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        self._next_mp_id = 0
        self._next_kf_id = 0

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf: KeyFrameData) -> int:
        if kf.kf_id < 0:
            kf.kf_id = self._next_kf_id
        self._next_kf_id = max(self._next_kf_id, kf.kf_id + 1)
        self.keyframes[kf.kf_id] = kf
        self.kf_obs.setdefault(kf.kf_id, {})
        self.covisibility.setdefault(kf.kf_id, {})
        return kf.kf_id

    def insert_map_point(self, position, descriptor=None) -> int:
        mp_id = self._next_mp_id
        self._next_mp_id += 1
        self.map_points[mp_id] = MapPointData(
            mp_id=mp_id, position=np.asarray(position, dtype=np.float64), descriptor=descriptor
        )
        self.mp_obs.setdefault(mp_id, {})
        return mp_id

    def remove_map_point(self, mp_id: int):
        for kf_id in list(self.mp_obs.get(mp_id, {})):
            self.remove_observation(kf_id, mp_id)
        self.map_points.pop(mp_id, None)
        self.mp_obs.pop(mp_id, None)

    # ------------------------------------------------------------------
    def add_observation(self, kf_id: int, mp_id: int, idx: int, update_stats: bool = True):
        """Parity with ``Map::addObservation`` (Map.cc:100-132): maintains both
        graph directions and increments covisibility with every other
        observer."""
        assert mp_id not in self.kf_obs[kf_id], "duplicate observation"
        for other_kf in self.mp_obs[mp_id]:
            if other_kf == kf_id:
                continue
            self.covisibility[kf_id][other_kf] = self.covisibility[kf_id].get(other_kf, 0) + 1
            self.covisibility[other_kf][kf_id] = self.covisibility[other_kf].get(kf_id, 0) + 1
        self.kf_obs[kf_id][mp_id] = idx
        self.mp_obs[mp_id][kf_id] = idx
        if update_stats:
            self.update_orientation_and_descriptor(mp_id)

    def remove_observation(self, kf_id: int, mp_id: int):
        self.kf_obs[kf_id].pop(mp_id, None)
        self.mp_obs[mp_id].pop(kf_id, None)
        for other_kf in self.mp_obs[mp_id]:
            if other_kf == kf_id:
                continue
            for a, b in ((kf_id, other_kf), (other_kf, kf_id)):
                c = self.covisibility[a].get(b, 0) - 1
                if c > 0:
                    self.covisibility[a][b] = c
                else:
                    self.covisibility[a].pop(b, None)

    def is_map_point_in_keyframe(self, mp_id: int, kf_id: int) -> int:
        """Feature index or -1 (``Map::isMapPointInKeyFrame``)."""
        return self.kf_obs.get(kf_id, {}).get(mp_id, -1)

    def n_observations(self, mp_id: int) -> int:
        return len(self.mp_obs.get(mp_id, {}))

    def common_observations(self, kf1: int, kf2: int) -> int:
        return self.covisibility.get(kf1, {}).get(kf2, 0)

    # ------------------------------------------------------------------
    def local_map_of_keyframe(self, kf_id: int) -> Tuple[Set[int], Set[int], Set[int]]:
        """(local map points, local keyframes, fixed keyframes), parity with
        ``Map::getLocalMapOfKeyFrame`` (Map.cc:178-209)."""
        local_kfs = {kf_id}
        local_mps = set(self.kf_obs.get(kf_id, {}))
        for cov_kf, n_obs in self.covisibility.get(kf_id, {}).items():
            if n_obs > self.min_common_obs:
                local_kfs.add(cov_kf)
                local_mps |= set(self.kf_obs.get(cov_kf, {}))
        all_kfs = set()
        for mp in local_mps:
            all_kfs |= set(self.mp_obs.get(mp, {}))
        return local_mps, local_kfs, all_kfs - local_kfs

    def fuse_map_points(self, mp1: int, mp2: int) -> int:
        """Merge duplicates, keeping the better-observed one
        (``Map::fuseMapPoints``, Map.cc:211-237). Returns the surviving id."""
        keep, kill = (mp1, mp2) if len(self.mp_obs[mp1]) > len(self.mp_obs[mp2]) else (mp2, mp1)
        for kf_id, idx in list(self.mp_obs[kill].items()):
            self.remove_observation(kf_id, kill)
            if self.is_map_point_in_keyframe(keep, kf_id) == -1:
                self.add_observation(kf_id, keep, idx, update_stats=False)
        self.remove_map_point(kill)
        self.update_orientation_and_descriptor(keep)
        return keep

    # ------------------------------------------------------------------
    def update_orientation_and_descriptor(self, mp_id: int):
        """Batched ``Map::updateOrientationAndDescriptor`` (Map.cc:270-321):
        mean viewing direction, best descriptor by minimal median Hamming to
        the other observations, scale-invariance range from its keyframe."""
        obs = self.mp_obs.get(mp_id, {})
        if not obs:
            return
        mp = self.map_points[mp_id]
        kf_ids = list(obs)
        descs = np.stack([self.keyframes[k].desc[obs[k]] for k in kf_ids])  # [M, 256]
        centers = np.stack([self.keyframes[k].center for k in kf_ids])
        rays = mp.position[None, :] - centers
        rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        mp.normal = rays.mean(axis=0)
        n = np.linalg.norm(mp.normal)
        if n > 0:
            mp.normal = mp.normal / n

        D = (descs[:, None, :] != descs[None, :, :]).sum(-1)  # [M, M] Hamming
        medians = np.partition(D, D.shape[1] // 2, axis=1)[:, D.shape[1] // 2]
        best = int(np.argmin(medians))
        mp.descriptor = descs[best]

        ref = self.keyframes[kf_ids[best]]
        dist = float(np.linalg.norm(mp.position - ref.center))
        octave = int(ref.octave[obs[kf_ids[best]]])
        max_inv = dist * ref.scale_factor**octave
        mp.max_distance_invariance = max_inv
        mp.min_distance_invariance = max_inv / ref.scale_factor ** (ref.n_scales - 1)

    # ------------------------------------------------------------------
    def set_global_transform(self, kf1: int, kf2: int, R, t):
        self.global_transforms[(kf1, kf2)] = (np.asarray(R), np.asarray(t))

    def get_global_transform(self, kf1: int, kf2: int):
        """Identity when unset, like ``Map::getGlobalKeyFramesTransformation``."""
        return self.global_transforms.get((kf1, kf2), (np.eye(3), np.zeros(3)))

    def check_keyframe(self, kf_id: int) -> None:
        """Observation-graph invariant (the reference's debug-only
        ``Map::checkKeyFrame``, Map.h:142-167, shipped commented out): the
        keyframe's observation dict references only registered map points,
        with no duplicate indices."""
        obs = self.kf_obs.get(kf_id, {})
        assert len(set(obs.values())) == len(obs), "duplicate feature indices"
        for mp_id in obs:
            assert mp_id in self.map_points, f"observation of unknown map point {mp_id}"

    def check_all_map_points_are_good(self, kf: "KeyFrameData", cam_project, chi2_max: float = 6.0):
        """Reprojection-sanity invariant (``Frame::checkAllMapPointsAreGood``,
        Frame.cc:399-415): every observed point reprojects within chi2_max
        scaled by the pyramid information. ``cam_project(p3d[N,3]) -> [N,2]``."""
        obs = self.kf_obs.get(kf.kf_id, {})
        if not obs:
            return
        mp_ids = list(obs)
        idx = np.array([obs[m] for m in mp_ids])
        pos = np.stack([self.map_points[m].position for m in mp_ids])
        proj = np.asarray(cam_project(pos @ kf.R_cw.T + kf.t_cw))
        err = ((proj - kf.kp[idx]) ** 2).sum(-1) / (kf.scale_factor ** (2 * kf.octave[idx]))
        assert (err < chi2_max).all(), f"map point reprojection over {chi2_max}: max {err.max():.3f}"

    def clone(self) -> "WorldMap":
        """Cheap snapshot: arrays are immutable-by-convention and shared."""
        import copy

        m = WorldMap(self.min_common_obs)
        m.keyframes = dict(self.keyframes)
        m.map_points = {k: dataclasses.replace(v) for k, v in self.map_points.items()}
        m.kf_obs = {k: dict(v) for k, v in self.kf_obs.items()}
        m.mp_obs = {k: dict(v) for k, v in self.mp_obs.items()}
        m.covisibility = {k: dict(v) for k, v in self.covisibility.items()}
        m.global_transforms = dict(self.global_transforms)
        m._next_kf_id = self._next_kf_id
        m._next_mp_id = self._next_mp_id
        return m


def build_pair_map(
    T1w,
    T2w,
    kp1,
    kp2,
    desc1,
    desc2,
    octave1,
    octave2,
    d1,
    d2,
    state,
    valid,
    scale_factor: float = 1.2,
    n_scales: int = 8,
) -> "WorldMap":
    """Populate a WorldMap from one refined keyframe pair: the live-pipeline
    equivalent of the reference's mapping insertion (Mapping.cc:183-247).

    Per valid match i, TWO map points enter the registry -- the landmark's
    position at keyframe 1 (state.p1[i]) observed by KF1, and its deformed
    position at keyframe 2 (state.p2[i]) observed by KF2 -- with observation
    graph entries and the refined global SE3 alignment stored in the pairwise
    transform store (Map.cc:323-343). The per-keyframe refined depth scales
    land on the KeyFrameData records (KeyFrame.cc:131-153 estimates them; the
    refinement's s1/s2 are the optimized values).
    """
    m = WorldMap()
    kp1 = np.asarray(kp1)
    kp2 = np.asarray(kp2)
    n = len(kp1)
    octave1 = np.zeros(n, np.int32) if octave1 is None else np.asarray(octave1)
    octave2 = np.zeros(n, np.int32) if octave2 is None else np.asarray(octave2)
    desc1 = np.zeros((n, 256), np.int8) if desc1 is None else np.asarray(desc1)
    desc2 = np.zeros((n, 256), np.int8) if desc2 is None else np.asarray(desc2)

    kf1 = KeyFrameData(
        kf_id=-1, R_cw=np.asarray(T1w[0]), t_cw=np.asarray(T1w[1]), kp=kp1,
        octave=octave1, desc=desc1, depth=None if d1 is None else np.asarray(d1),
        depth_scale=float(state.s1), scale_factor=scale_factor, n_scales=n_scales,
    )
    kf2 = KeyFrameData(
        kf_id=-1, R_cw=np.asarray(T2w[0]), t_cw=np.asarray(T2w[1]), kp=kp2,
        octave=octave2, desc=desc2, depth=None if d2 is None else np.asarray(d2),
        depth_scale=float(state.s2), scale_factor=scale_factor, n_scales=n_scales,
    )
    id1 = m.insert_keyframe(kf1)
    id2 = m.insert_keyframe(kf2)

    p1 = np.asarray(state.p1)
    p2 = np.asarray(state.p2)
    for i in np.nonzero(np.asarray(valid, dtype=bool))[0]:
        mp1 = m.insert_map_point(p1[i], descriptor=desc1[i])
        mp2 = m.insert_map_point(p2[i], descriptor=desc2[i])
        m.add_observation(id1, mp1, int(i))
        m.add_observation(id2, mp2, int(i))

    m.set_global_transform(id1, id2, np.asarray(state.Rg), np.asarray(state.tg))
    return m
